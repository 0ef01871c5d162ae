"""paligemma-3b -- PaliGemma 3B VLM: SigLIP vision encoder + gemma decoder
[arXiv:2407.07726].  The SigLIP tower + projector input is a stub by
assignment: ``patches`` arrive as precomputed (B, 256, 1152) embeddings;
the learned projector and the gemma language stack are implemented.

18L, d_model=2048, 8 heads (kv=1, MQA), head_dim=256, d_ff=16384,
vocab=257216.  Prefix-LM mask over the 256 patch tokens.
The values of ``src/repro/configs/paligemma_3b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
    activation="gelu", frontend="vision", frontend_dim=1152, n_prefix=256,
    tie_embeddings=True)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
    activation="gelu", frontend="vision", frontend_dim=64, n_prefix=8)
