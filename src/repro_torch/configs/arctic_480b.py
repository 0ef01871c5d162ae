"""arctic-480b -- Snowflake Arctic 480B: dense-MoE hybrid, 128 experts
top-2 with a parallel dense residual MLP [hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads GQA kv=8, expert d_ff=4864, vocab=32000.
Experts are expert-parallel (128 experts over the 16-way model axis).
The values of ``src/repro/configs/arctic_480b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, n_experts=128,
    top_k=2, dense_residual=True, activation="silu", tie_embeddings=True)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, n_experts=4, top_k=2,
    dense_residual=True)
