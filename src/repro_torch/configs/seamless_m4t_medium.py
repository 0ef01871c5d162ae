"""seamless-m4t-medium -- SeamlessM4T medium speech/text translation
[arXiv:2308.11596]; we implement the TRANSFORMER BACKBONE (encoder-decoder);
the mel-spectrogram + conv feature extractor frontend is a stub by
assignment: ``frames`` arrive as precomputed (B, S_enc, 1024) embeddings.

12L encoder + 12L decoder, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=256206.
The values of ``src/repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12,
    n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, activation="gelu_plain", norm="layernorm",
    frontend="audio", frontend_dim=1024, tie_embeddings=True)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    activation="gelu_plain", norm="layernorm", frontend="audio",
    frontend_dim=64)
