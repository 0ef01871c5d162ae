"""Layer building blocks per architecture family (``src/repro/models/
blocks.py``); this slice ports the ``rwkv6`` family.

Each family exposes ``init_*_layer(gen, cfg, lead)``, ``*_layer_seq`` and
``*_layer_decode``.  The model assembly (:mod:`repro_torch.models.model`)
draws a family's layers as one stack (``lead=(n_layers,)``) and applies
them in a Python loop.  The attention, MLA, MLP, MoE and Mamba2 families
wait for later slices (ROADMAP queue 1 item 13); their config accessors
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..nn import ssm as S
from ..nn.module import (init_layernorm, init_rmsnorm, layernorm, rmsnorm)

__all__ = ["ModelConfig", "FAMILIES", "init_rwkv_layer", "rwkv_layer_seq",
           "rwkv_layer_decode"]

FAMILIES = ("dense", "moe", "rwkv6", "hybrid", "encdec", "vlm")


def _later(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 13); the port "
        "serves the rwkv6 family")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture, every field of the reference's ``ModelConfig``.
    Source citations live in repro_torch/configs/<name>.py."""

    name: str
    family: str               # dense | moe | rwkv6 | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0         # 0 -> d_model // n_heads
    activation: str = "silu"
    rotary_frac: float = 1.0  # chatglm3: 0.5
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    dense_residual: bool = False
    capacity_factor: float = 1.25
    # --- MLA (minicpm3) ---
    mla: bool = False
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    # --- SSM / hybrid ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    attn_every: int = 6       # hybrid: shared attn after every k mamba layers
    # --- enc-dec / prefix frontends ---
    n_enc_layers: int = 0
    frontend: str = "none"    # none | vision | audio
    frontend_dim: int = 0     # raw embedding dim from the stub frontend
    n_prefix: int = 0         # vlm: number of patch tokens
    # --- numerics / perf ---
    dtype: Any = torch.bfloat16
    remat: bool = True        # kept as data; the port stores no remat graph
    remat_policy: Optional[str] = None
    q_chunk: Optional[int] = None   # chunked-query attention (flash-coarse)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def attn_cfg(self, window: Optional[int] = "cfg"):
        _later("attention (nn/attention.py)")

    def mla_cfg(self):
        _later("MLA attention (nn/attention.py)")

    def mlp_cfg(self):
        _later("the MLP (nn/moe.py)")

    def moe_cfg(self):
        _later("MoE (nn/moe.py)")

    def rwkv_cfg(self) -> S.Rwkv6Config:
        return S.Rwkv6Config(d_model=self.d_model, head_dim=self.ssm_head_dim,
                             d_ff=self.d_ff)

    def mamba_cfg(self):
        _later("Mamba2 (the Mamba2 half of nn/ssm.py)")


def _norm_fns(cfg: ModelConfig):
    if cfg.norm == "rmsnorm":
        return init_rmsnorm, rmsnorm
    return init_layernorm, layernorm


# ---------------------------------------------------------------------------
# RWKV6 layer (time mix + channel mix live inside rwkv6_block)
# ---------------------------------------------------------------------------

def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    init_n, _ = _norm_fns(cfg)
    return {"ln": init_n(gen, cfg.d_model, lead=lead),
            "blk": S.init_rwkv6_block(gen, cfg.rwkv_cfg(), lead=lead)}


def rwkv_layer_seq(p, cfg: ModelConfig, x, state=None):
    _, norm = _norm_fns(cfg)
    y, st = S.rwkv6_block(p["blk"], cfg.rwkv_cfg(), norm(p["ln"], x), state)
    return y, st


def rwkv_layer_decode(p, cfg: ModelConfig, x, state):
    _, norm = _norm_fns(cfg)
    return S.rwkv6_decode(p["blk"], cfg.rwkv_cfg(), norm(p["ln"], x), state)
