"""Layer building blocks per architecture family (``src/repro/models/
blocks.py``): the dense / MLA / MoE decoder layer (also the VLM's text
stack and the hybrid's shared block), the RWKV6 and Mamba2 layers, and the
encoder-decoder's encoder and cross-attention decoder layers.

Each family exposes ``init_*_layer(gen, cfg, lead)``, ``*_layer_seq`` and
``*_layer_decode``.  The model assembly (:mod:`repro_torch.models.model`)
draws a family's layers as one stack (``lead=(n_layers,)``) and applies
them in a Python loop.  A layer that collects its prefill cache keeps the
keys and values (or MLA's latent) its attention has just computed, where
the reference computes them a second time; the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..nn import attention as A
from ..nn import moe as M
from ..nn import ssm as S
from ..nn.module import (init_layernorm, init_rmsnorm, layernorm, rmsnorm)

__all__ = ["ModelConfig", "FAMILIES", "init_decoder_layer",
           "decoder_layer_seq", "decoder_layer_decode", "init_decoder_cache",
           "init_rwkv_layer", "rwkv_layer_seq", "rwkv_layer_decode",
           "init_mamba_layer", "mamba_layer_seq", "mamba_layer_decode",
           "init_encoder_layer", "encoder_layer_seq",
           "init_xattn_decoder_layer", "xattn_decoder_layer_seq",
           "xattn_decoder_layer_decode", "init_xattn_cache"]

FAMILIES = ("dense", "moe", "rwkv6", "hybrid", "encdec", "vlm")


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

    def attn_cfg(self, window: Optional[int] = "cfg") -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rotary_frac=self.rotary_frac, rope_theta=self.rope_theta,
            window=self.window if window == "cfg" else window,
            qkv_bias=self.qkv_bias)

    def mla_cfg(self) -> A.MLAConfig:
        return A.MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim, rope_theta=self.rope_theta)

    def mlp_cfg(self) -> M.MlpConfig:
        return M.MlpConfig(self.d_model, self.d_ff, self.activation)

    def moe_cfg(self) -> M.MoeConfig:
        return M.MoeConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, activation=self.activation,
            dense_residual=self.dense_residual,
            capacity_factor=self.capacity_factor)

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
# dense / MLA / MoE decoder layers (attention + FFN)
# ---------------------------------------------------------------------------

def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """ln1, ln2, the attention (GQA or MLA), the FFN (MLP or MoE), drawn in
    that order."""
    init_n, _ = _norm_fns(cfg)
    p = {"ln1": init_n(gen, cfg.d_model, lead=lead),
         "ln2": init_n(gen, cfg.d_model, lead=lead)}
    if cfg.mla:
        p["attn"] = A.init_mla(gen, cfg.mla_cfg(), lead=lead)
    else:
        p["attn"] = A.init_attention(gen, cfg.attn_cfg(), lead=lead)
    if cfg.n_experts > 0:
        p["ffn"] = M.init_moe(gen, cfg.moe_cfg(), lead=lead)
    else:
        p["ffn"] = M.init_mlp(gen, cfg.mlp_cfg(), lead=lead)
    return p


def _ffn(p, cfg: ModelConfig, h):
    """The FFN's output and the MoE loss (0 for an MLP)."""
    if cfg.n_experts > 0:
        return M.moe(p["ffn"], cfg.moe_cfg(), h)
    return M.mlp(p["ffn"], cfg.mlp_cfg(), h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def decoder_layer_seq(p, cfg: ModelConfig, x, positions, mode="causal",
                      prefix_len: int = 0, collect_cache: bool = False,
                      cache_dtype=torch.bfloat16,
                      window: Optional[int] = "cfg"):
    """Attention under ``mode`` (and the window, ``"cfg"`` the config's),
    then the FFN.  Returns (x, cache or None, aux): the cache is {k, v}
    (GQA) or {ckv, krope} (MLA) in ``cache_dtype``; aux the MoE loss."""
    _, norm = _norm_fns(cfg)
    h = norm(p["ln1"], x)
    if cfg.mla:
        y, ckv, krope = A.mla_attention_latent(p["attn"], cfg.mla_cfg(), h,
                                               positions, q_chunk=cfg.q_chunk)
        cache = {"ckv": ckv, "krope": krope}
    else:
        y, k, v = A.attention_kv(p["attn"], cfg.attn_cfg(window), h,
                                 positions, mode, prefix_len,
                                 q_chunk=cfg.q_chunk)
        cache = {"k": k, "v": v}
    cache = ({n: t.to(cache_dtype) for n, t in cache.items()}
             if collect_cache else None)
    x = x + y
    y, aux = _ffn(p, cfg, norm(p["ln2"], x))
    return x + y, cache, aux


def decoder_layer_decode(p, cfg: ModelConfig, x, cache, pos,
                         window: Optional[int] = "cfg"):
    """One token; the cache's tensors are updated in place."""
    _, norm = _norm_fns(cfg)
    h = norm(p["ln1"], x)
    if cfg.mla:
        y, cache = A.mla_decode(p["attn"], cfg.mla_cfg(), h, cache, pos)
    else:
        y, cache = A.attention_decode(p["attn"], cfg.attn_cfg(window), h,
                                      cache, pos)
    x = x + y
    y, _ = _ffn(p, cfg, norm(p["ln2"], x))
    return x + y, cache


def init_decoder_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, window: Optional[int] = "cfg",
                       device=None):
    if cfg.mla:
        return A.init_mla_cache(batch, cache_len, cfg.mla_cfg(), dtype,
                                device)
    w = cfg.window if window == "cfg" else window
    if w is not None and w < cache_len:
        return A.init_window_cache(batch, w, cfg.attn_cfg(w), dtype, device)
    return A.init_full_cache(batch, cache_len, cfg.attn_cfg(w), dtype, device)


# ---------------------------------------------------------------------------
# RWKV6 layer (time mix + channel mix live inside rwkv6_block)
# ---------------------------------------------------------------------------

def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    init_n, _ = _norm_fns(cfg)
    return {"ln": init_n(gen, cfg.d_model, lead=lead),
            "blk": S.init_rwkv6_block(gen, cfg.rwkv_cfg(), lead=lead)}


def rwkv_layer_seq(p, cfg: ModelConfig, x, state=None, plain_scan=False):
    _, norm = _norm_fns(cfg)
    y, st = S.rwkv6_block(p["blk"], cfg.rwkv_cfg(), norm(p["ln"], x), state,
                          plain_scan=plain_scan)
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


def mamba_layer_seq(p, cfg: ModelConfig, x, state=None, plain_scan=False):
    _, norm = _norm_fns(cfg)
    y, st = S.mamba2_block(p["blk"], cfg.mamba_cfg(), norm(p["ln"], x), state,
                           plain_scan=plain_scan)
    return x + y, st


def mamba_layer_decode(p, cfg: ModelConfig, x, state):
    _, norm = _norm_fns(cfg)
    y, st = S.mamba2_decode(p["blk"], cfg.mamba_cfg(), norm(p["ln"], x), state)
    return x + y, st


# ---------------------------------------------------------------------------
# Encoder layer (seamless encoder: bidirectional self-attn + MLP)
# ---------------------------------------------------------------------------

def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig, lead=()):
    init_n, _ = _norm_fns(cfg)
    return {"ln1": init_n(gen, cfg.d_model, lead=lead),
            "ln2": init_n(gen, cfg.d_model, lead=lead),
            "attn": A.init_attention(gen, cfg.attn_cfg(), lead=lead),
            "ffn": M.init_mlp(gen, cfg.mlp_cfg(), lead=lead)}


def encoder_layer_seq(p, cfg: ModelConfig, x, positions):
    _, norm = _norm_fns(cfg)
    x = x + A.attention(p["attn"], cfg.attn_cfg(), norm(p["ln1"], x),
                        positions, mode="full", q_chunk=cfg.q_chunk)
    return x + M.mlp(p["ffn"], cfg.mlp_cfg(), norm(p["ln2"], x))


# ---------------------------------------------------------------------------
# Cross-attention decoder layer (seamless decoder)
# ---------------------------------------------------------------------------

def init_xattn_decoder_layer(gen: torch.Generator, cfg: ModelConfig,
                             lead=()):
    init_n, _ = _norm_fns(cfg)
    return {"ln1": init_n(gen, cfg.d_model, lead=lead),
            "ln2": init_n(gen, cfg.d_model, lead=lead),
            "ln3": init_n(gen, cfg.d_model, lead=lead),
            "self_attn": A.init_attention(gen, cfg.attn_cfg(), lead=lead),
            "cross_attn": A.init_cross_attention(gen, cfg.attn_cfg(),
                                                 lead=lead),
            "ffn": M.init_mlp(gen, cfg.mlp_cfg(), lead=lead)}


def xattn_decoder_layer_seq(p, cfg: ModelConfig, x, positions, enc_out,
                            collect_cache: bool = False,
                            cache_dtype=torch.bfloat16):
    """Causal self-attention, cross-attention over ``enc_out``, the MLP.
    Returns (x, cache or None): ``{"self": {k, v}, "cross": {k, v}}``."""
    _, norm = _norm_fns(cfg)
    acfg = cfg.attn_cfg()
    y, k, v = A.attention_kv(p["self_attn"], acfg, norm(p["ln1"], x),
                             positions, mode="causal", q_chunk=cfg.q_chunk)
    x = x + y
    x = x + A.cross_attention(p["cross_attn"], acfg, norm(p["ln2"], x),
                              enc_out, q_chunk=cfg.q_chunk)
    x = x + M.mlp(p["ffn"], cfg.mlp_cfg(), norm(p["ln3"], x))
    cache = None
    if collect_cache:
        cache = {"self": {"k": k.to(cache_dtype), "v": v.to(cache_dtype)},
                 "cross": A.make_cross_cache(p["cross_attn"], acfg, enc_out,
                                             cache_dtype)}
    return x, cache


def xattn_decoder_layer_decode(p, cfg: ModelConfig, x, cache, pos):
    """One token; the self cache's tensors are updated in place."""
    _, norm = _norm_fns(cfg)
    acfg = cfg.attn_cfg()
    y, self_cache = A.attention_decode(p["self_attn"], acfg,
                                       norm(p["ln1"], x), cache["self"], pos)
    x = x + y
    x = x + A.cross_attention_decode(p["cross_attn"], acfg,
                                     norm(p["ln2"], x), cache["cross"])
    x = x + M.mlp(p["ffn"], cfg.mlp_cfg(), norm(p["ln3"], x))
    return x, {"self": self_cache, "cross": cache["cross"]}


def init_xattn_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int, dtype=torch.bfloat16, device=None):
    acfg = cfg.attn_cfg()
    return {"self": A.init_full_cache(batch, cache_len, acfg, dtype, device),
            "cross": A.init_full_cache(batch, enc_len, acfg, dtype, device)}
