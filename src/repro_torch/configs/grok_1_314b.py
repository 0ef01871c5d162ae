"""grok-1-314b -- Grok-1 314B MoE, 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model=6144, 48 heads GQA kv=8, expert d_ff=32768, vocab=131072.
Experts are ffn-parallel (8 experts < 16-way model axis -> shard d_ff).
The values of ``src/repro/configs/grok_1_314b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8,
    top_k=2, activation="gelu", tie_embeddings=True)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, n_experts=4, top_k=2,
    activation="gelu")
