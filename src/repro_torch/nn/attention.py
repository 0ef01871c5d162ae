"""Attention blocks (``src/repro/nn/attention.py``); this slice ports the
GQA half: MHA / GQA / MQA, sliding windows and prefix-LM masks, with full
and windowed decode caches.  MLA and cross-attention wait for the decoder
and encdec slices (ROADMAP queue 1 item 13).

The reference computes attention in jnp (an einsum and an f32 softmax), not
in a Pallas kernel, and so does the port, with plain tensor ops.  Scores
are formed in the activations' dtype and divided by sqrt(head_dim) in f32
(the reference divides by a numpy scalar, which promotes bf16 to f32); the
softmax runs in f32 and its probabilities are cast back.

Cache formats
  full GQA   : {k, v: (B, S, Hk, hd)}                 write at ``pos``
  windowed   : {k, v: (B, W, Hk, hd), positions: (B, W) int32}  ring buffer

``attention_decode`` writes the new key and value (and, in a windowed
cache, the position) into the cache's tensors in place and returns the
same dict's entries, where the reference returns an updated copy: a step
then moves one token's keys, not the whole cache.  The reference's
sharding specs are dropped (one card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .module import apply_rope, dense, init_dense

__all__ = ["NEG_INF", "AttnConfig", "init_attention", "make_mask",
           "attention", "init_full_cache", "init_window_cache",
           "attention_decode"]

NEG_INF = -1e30

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rotary_frac: float = 1.0      # chatglm3 "2d" RoPE = 0.5
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window size (h2o-danube3)
    qkv_bias: bool = False

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.rotary_frac)
        return rd - rd % 2


def init_attention(gen: torch.Generator, cfg: AttnConfig, lead=()):
    h, hk, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": init_dense(gen, d, h * hd, bias=cfg.qkv_bias, lead=lead),
        "wk": init_dense(gen, d, hk * hd, bias=cfg.qkv_bias, lead=lead),
        "wv": init_dense(gen, d, hk * hd, bias=cfg.qkv_bias, lead=lead),
        "wo": init_dense(gen, h * hd, d, lead=lead),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _gqa_scores(q, k):
    """q: (B,S,Hk,G,hd), k: (B,T,Hk,hd) -> (B,Hk,G,S,T)."""
    return torch.einsum("bskgd,btkd->bkgst", q, k)


def _gqa_out(probs, v):
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _scaled(scores, hd: int):
    """scores / sqrt(hd) in f32, as the reference's division by a numpy
    scalar promotes them."""
    return scores.to(_F32) / math.sqrt(hd)


def _mask_bias(mask: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(mask, 0.0, NEG_INF).to(dtype)


def make_mask(s: int, t: int, mode: str = "causal",
              window: Optional[int] = None, prefix_len: int = 0,
              q_offset: int = 0, device=None) -> torch.Tensor:
    """(s, t) boolean mask; True = attend.  q position i is q_offset + i."""
    qi = torch.arange(s, device=device)[:, None] + q_offset
    ki = torch.arange(t, device=device)[None, :]
    if mode == "full":
        m = torch.ones((s, t), dtype=torch.bool, device=device)
    elif mode == "causal":
        m = ki <= qi
    elif mode == "prefix":
        m = (ki <= qi) | (ki < prefix_len)
    else:
        raise ValueError(mode)
    if window is not None:
        m = m & (ki > qi - window)
    return m


def attention(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              mode: str = "causal", prefix_len: int = 0,
              q_chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention.  x: (B,S,D); positions: (B,S).

    q_chunk: process queries in blocks of this size, so the materialized
    score tensor is (B,H,q_chunk,S) instead of (B,H,S,S).
    """
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    q = _split_heads(dense(p["wq"], x), h, hd)
    k = _split_heads(dense(p["wk"], x), hk, hd)
    v = _split_heads(dense(p["wv"], x), hk, hd)
    if cfg.rotary_dim > 0:
        q = apply_rope(q, positions, cfg.rotary_dim, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rotary_dim, cfg.rope_theta)
    q = q.reshape(b, s, hk, g, hd)

    def attend_block(q_blk, offset, blk_len):
        scores = _scaled(_gqa_scores(q_blk, k), hd)
        mask = make_mask(blk_len, s, mode, cfg.window, prefix_len,
                         q_offset=offset, device=x.device)
        scores = scores + _mask_bias(mask, scores.dtype)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return _gqa_out(probs, v)

    if q_chunk and s > q_chunk and s % q_chunk == 0:
        outs = [attend_block(q[:, i: i + q_chunk], i, q_chunk)
                for i in range(0, s, q_chunk)]
        out = torch.cat(outs, dim=1).reshape(b, s, h * hd)
    else:
        out = attend_block(q, 0, s).reshape(b, s, h * hd)
    return dense(p["wo"], out)


def init_full_cache(batch: int, seq: int, cfg: AttnConfig,
                    dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, seq, hk, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, seq, hk, hd), dtype=dtype, device=device)}


def init_window_cache(batch: int, window: int, cfg: AttnConfig,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    cache = init_full_cache(batch, window, cfg, dtype, device)
    cache["positions"] = torch.full((batch, window), -1, dtype=torch.int32,
                                    device=device)
    return cache


def attention_decode(p, cfg: AttnConfig, x: torch.Tensor,
                     cache: Dict[str, Any],
                     pos) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  x: (B,1,D); pos: int (the same for the batch).

    Full cache: write kv at ``pos`` and attend over [0, pos].
    Windowed cache: ring-buffer slot pos % W; mask by stored positions.
    The cache's tensors are updated in place (the module docstring says
    why).
    """
    b = x.shape[0]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _split_heads(dense(p["wq"], x), h, hd)
    k_new = _split_heads(dense(p["wk"], x), hk, hd)
    v_new = _split_heads(dense(p["wv"], x), hk, hd)
    if cfg.rotary_dim > 0:
        q = apply_rope(q, positions, cfg.rotary_dim, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rotary_dim, cfg.rope_theta)
    q = q.reshape(b, 1, hk, g, hd)

    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    windowed = "positions" in cache
    slot = pos % t if windowed else pos
    if not 0 <= slot < t:
        raise IndexError(f"decode position {pos} is outside the {t}-slot "
                         "cache; grow the cache first")
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    scores = _scaled(_gqa_scores(q, k.to(x.dtype)), hd)   # (B,Hk,G,1,T)
    if windowed:
        pos_ids = cache["positions"]
        pos_ids[:, slot] = pos
        valid = (pos_ids <= pos) & (pos_ids >= 0)
        if cfg.window is not None:
            valid = valid & (pos_ids > pos - cfg.window)
        mask = valid[:, None, None, None, :]
    else:
        mask = (torch.arange(t, device=x.device) <= pos)[None, None, None,
                                                          None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, v.to(x.dtype)).reshape(b, 1, h * hd)
    return dense(p["wo"], out), cache
