"""chatglm3-6b -- ChatGLM3 6B: GQA kv=2, RoPE applied to half the head
channels ("2d" rotary), qkv bias [arXiv:2406.12793].

28L, d_model=4096, 32 heads kv=2, d_ff=13696 (SwiGLU), vocab=65024.
The values of ``src/repro/configs/chatglm3_6b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024, rotary_frac=0.5,
    qkv_bias=True, activation="silu", tie_embeddings=False)

SMOKE = ModelConfig(
    name="chatglm3-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=384, vocab=512, rotary_frac=0.5,
    qkv_bias=True, tie_embeddings=False)
