"""minicpm3-4b -- MiniCPM3 4B with multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B].

62L, d_model=2560, 40 heads (kv=40 -- MLA shares a 256-dim latent),
d_ff=6400, vocab=73448.  MLA dims from the model card: q_lora 768,
kv_lora 256, qk_nope 64, qk_rope 32, v_head 64.
The values of ``src/repro/configs/minicpm3_4b.py``.
"""
from repro_torch.models.blocks import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448, mla=True,
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64, activation="silu", tie_embeddings=True)

SMOKE = ModelConfig(
    name="minicpm3-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=320, vocab=512, mla=True,
    q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16)
