"""Layer building blocks per architecture family (``src/repro/models/
blocks.py``); the port has the ``rwkv6`` family and the ``hybrid`` one
(Mamba2 layers and the shared GQA attention + MLP decoder layer).

Each family exposes ``init_*_layer(gen, cfg, lead)``, ``*_layer_seq`` and
``*_layer_decode``.  The model assembly (:mod:`repro_torch.models.model`)
draws a family's layers as one stack (``lead=(n_layers,)``) and applies
them in a Python loop.  MLA and MoE wait for the decoder slice (ROADMAP
queue 1 item 13): their config accessors and the decoder layer's MLA and
MoE branches raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..nn import attention as A
from ..nn import moe as M
from ..nn import ssm as S
from ..nn.module import (apply_rope, dense, init_layernorm, init_rmsnorm,
                         layernorm, rmsnorm)

__all__ = ["ModelConfig", "FAMILIES", "init_decoder_layer",
           "decoder_layer_seq", "decoder_layer_decode", "init_decoder_cache",
           "init_rwkv_layer", "rwkv_layer_seq", "rwkv_layer_decode",
           "init_mamba_layer", "mamba_layer_seq", "mamba_layer_decode"]

FAMILIES = ("dense", "moe", "rwkv6", "hybrid", "encdec", "vlm")


def _later(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 13); the port "
        "serves the rwkv6 and hybrid families")


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

    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rotary_frac=self.rotary_frac, rope_theta=self.rope_theta,
            window=self.window, qkv_bias=self.qkv_bias)

    def mla_cfg(self):
        _later("MLA attention (nn/attention.py)")

    def mlp_cfg(self) -> M.MlpConfig:
        return M.MlpConfig(self.d_model, self.d_ff, self.activation)

    def moe_cfg(self):
        _later("MoE (nn/moe.py)")

    def rwkv_cfg(self) -> S.Rwkv6Config:
        return S.Rwkv6Config(d_model=self.d_model, head_dim=self.ssm_head_dim,
                             d_ff=self.d_ff)

    def mamba_cfg(self) -> S.Mamba2Config:
        return S.Mamba2Config(d_model=self.d_model, d_state=self.ssm_state,
                              head_dim=self.ssm_head_dim)


def _norm_fns(cfg: ModelConfig):
    if cfg.norm == "rmsnorm":
        return init_rmsnorm, rmsnorm
    return init_layernorm, layernorm


# ---------------------------------------------------------------------------
# dense decoder layer (attention + MLP); the hybrid's shared block
# ---------------------------------------------------------------------------

def _dense_only(cfg: ModelConfig):
    if cfg.mla:
        _later("the MLA decoder layer (nn/attention.py MLA)")
    if cfg.n_experts > 0:
        _later("the MoE decoder layer (nn/moe.py MoE)")


def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    _dense_only(cfg)
    init_n, _ = _norm_fns(cfg)
    return {"ln1": init_n(gen, cfg.d_model, lead=lead),
            "ln2": init_n(gen, cfg.d_model, lead=lead),
            "attn": A.init_attention(gen, cfg.attn_cfg(), lead=lead),
            "ffn": M.init_mlp(gen, cfg.mlp_cfg(), lead=lead)}


def decoder_layer_seq(p, cfg: ModelConfig, x, positions,
                      collect_cache: bool = False,
                      cache_dtype=torch.bfloat16):
    """Causal attention over the config's own window, then the MLP.
    Returns (x, cache or None, aux); aux is the MoE loss, 0 here."""
    _dense_only(cfg)
    _, norm = _norm_fns(cfg)
    h = norm(p["ln1"], x)
    cache = None
    acfg = cfg.attn_cfg()
    y = A.attention(p["attn"], acfg, h, positions, q_chunk=cfg.q_chunk)
    if collect_cache:
        k = A._split_heads(dense(p["attn"]["wk"], h), acfg.n_kv_heads,
                           acfg.head_dim)
        v = A._split_heads(dense(p["attn"]["wv"], h), acfg.n_kv_heads,
                           acfg.head_dim)
        if acfg.rotary_dim > 0:
            k = apply_rope(k, positions, acfg.rotary_dim, acfg.rope_theta)
        cache = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
    x = x + y
    h = norm(p["ln2"], x)
    y = M.mlp(p["ffn"], cfg.mlp_cfg(), h)
    return x + y, cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)


def decoder_layer_decode(p, cfg: ModelConfig, x, cache, pos):
    """One token; the cache's tensors are updated in place."""
    _dense_only(cfg)
    _, norm = _norm_fns(cfg)
    h = norm(p["ln1"], x)
    y, cache = A.attention_decode(p["attn"], cfg.attn_cfg(), h, cache, pos)
    x = x + y
    h = norm(p["ln2"], x)
    return x + M.mlp(p["ffn"], cfg.mlp_cfg(), h), cache


def init_decoder_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, window: Optional[int] = "cfg",
                       device=None):
    if cfg.mla:
        _later("the MLA latent cache (nn/attention.py MLA)")
    w = cfg.window if window == "cfg" else window
    if w is not None and w < cache_len:
        return A.init_window_cache(batch, w, cfg.attn_cfg(), dtype, device)
    return A.init_full_cache(batch, cache_len, cfg.attn_cfg(), dtype, device)


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


# ---------------------------------------------------------------------------
# Mamba2 layer (hybrid backbone)
# ---------------------------------------------------------------------------

def init_mamba_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    init_n, _ = _norm_fns(cfg)
    return {"ln": init_n(gen, cfg.d_model, lead=lead),
            "blk": S.init_mamba2_block(gen, cfg.mamba_cfg(), lead=lead)}


def mamba_layer_seq(p, cfg: ModelConfig, x, state=None):
    _, norm = _norm_fns(cfg)
    y, st = S.mamba2_block(p["blk"], cfg.mamba_cfg(), norm(p["ln"], x), state)
    return x + y, st


def mamba_layer_decode(p, cfg: ModelConfig, x, state):
    _, norm = _norm_fns(cfg)
    y, st = S.mamba2_decode(p["blk"], cfg.mamba_cfg(), norm(p["ln"], x), state)
    return x + y, st
