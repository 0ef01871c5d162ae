"""h2o-danube-3-4b -- H2O Danube3 4B, llama+mistral mix with sliding-window
attention [arXiv:2401.16818] (danube lineage; window 4096).

24L, d_model=3840, 32 heads GQA kv=8, d_ff=10240, vocab=32000,
SWA window=4096.  Runs long_500k via the windowed cache.
The values of ``src/repro/configs/h2o_danube_3_4b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, window=4096,
    activation="silu", tie_embeddings=False)

SMOKE = ModelConfig(
    name="danube-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=320, vocab=512, window=32,
    tie_embeddings=False)
