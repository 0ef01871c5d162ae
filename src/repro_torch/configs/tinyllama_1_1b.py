"""tinyllama-1.1b -- TinyLlama 1.1B, llama2 architecture at small scale
[arXiv:2401.02385].

22L, d_model=2048, 32 heads GQA kv=4, d_ff=5632 (SwiGLU), vocab=32000.
The values of ``src/repro/configs/tinyllama_1_1b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000, activation="silu",
    tie_embeddings=False)

SMOKE = ModelConfig(
    name="tinyllama-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=352, vocab=512, tie_embeddings=False)
