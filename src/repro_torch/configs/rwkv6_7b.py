"""rwkv6-7b -- RWKV-6 "Finch" 7B: attention-free linear RNN with
data-dependent per-channel decay [arXiv:2404.05892]; the values of
``src/repro/configs/rwkv6_7b.py``.

32L, d_model=4096, head_dim=64 (64 heads), channel-mix hidden 14336,
vocab 65536.  About 7.25 B parameters.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv6", n_layers=32, d_model=4096,
    d_ff=14336, vocab=65536, ssm_head_dim=64, norm="layernorm",
    tie_embeddings=True)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="rwkv6", n_layers=2, d_model=128,
    d_ff=448, vocab=512, ssm_head_dim=32, norm="layernorm")
