"""zamba2-7b -- Zamba2 7B hybrid: Mamba2 backbone with shared attention
blocks [arXiv:2411.15242]; the values of ``src/repro/configs/zamba2_7b.py``.

81 mamba2 layers (d_model=3584, d_inner 7168, 112 heads x 64, ssm_state=64,
conv 4), one shared attention + gated-SiLU MLP block (32 heads, kv=32,
head dim 112, full RoPE, d_ff=14336) applied after every 6 mamba layers
(13 applications + 3 trailing mamba layers), vocab 32000, tied embeddings.
About 6.64 B parameters.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, ssm_state=64,
    ssm_head_dim=64, attn_every=6, activation="silu", tie_embeddings=True)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=5, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, ssm_state=16,
    ssm_head_dim=32, attn_every=2)
