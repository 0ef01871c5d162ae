"""Attention blocks (``src/repro/nn/attention.py``): MHA / GQA / MQA,
sliding windows and prefix-LM masks with full and windowed decode caches,
MiniCPM3-style multi-head latent attention (MLA) with its latent cache, and
the encoder-decoder's cross-attention.

The reference computes attention in jnp (einsums and an f32 softmax), not
in a Pallas kernel, and so does the port, with plain tensor ops.  Scores
are formed in the activations' dtype and divided by sqrt(head_dim) in f32
(the reference divides by a numpy scalar, which promotes bf16 to f32); the
softmax runs in f32 and its probabilities are cast back.  MLA adds its two
score products in the activations' dtype before that division.

Cache formats
  full GQA   : {k, v: (B, S, Hk, hd)}                 write at ``pos``
  windowed   : {k, v: (B, W, Hk, hd), positions: (B, W) int32}  ring buffer
  MLA latent : {ckv: (B, S, dc), krope: (B, S, dr)}    write at ``pos``
  cross      : {k, v: (B, T_enc, Hk, hd)}             made at prefill

``attention_decode`` and ``mla_decode`` write the new entries (and, in a
windowed cache, the position) into the cache's tensors in place and return
the same dict's entries, where the reference returns an updated copy: a
step then moves one token's keys, not the whole cache.

A full cache under a windowed config (a prefill collects every position)
masks by the window in decode too: key positions ``<= pos`` and ``> pos -
window``, as the windowed ``attention`` masks.  The reference masks only
``<= pos`` there (``src/repro/nn/attention.py:216-218``), so past the
window its decode leaves its own forward; up to the window the two masks
agree.  Under a model axis (``model=``) the GQA attention, MLA and the
cross-attention run tensor-parallel over the reference's specs
(:func:`attention_kv`, :func:`mla_attention_latent`,
:func:`cross_attention`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import tensor_parallel as TP
from .module import apply_rope, dense, init_dense, init_rmsnorm, rmsnorm

__all__ = ["NEG_INF", "AttnConfig", "MLAConfig", "init_attention",
           "make_mask", "attention", "init_full_cache", "init_window_cache",
           "attention_decode", "init_mla", "mla_attention", "init_mla_cache",
           "mla_decode", "init_cross_attention", "cross_attention",
           "make_cross_cache", "cross_attention_decode"]

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


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    rope_theta: float = 10000.0


# ---------------------------------------------------------------------------
# Standard GQA attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: AttnConfig, lead=()):
    h, hk, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": init_dense(gen, d, h * hd, bias=cfg.qkv_bias, lead=lead),
        "wk": init_dense(gen, d, hk * hd, bias=cfg.qkv_bias, lead=lead),
        "wv": init_dense(gen, d, hk * hd, bias=cfg.qkv_bias, lead=lead),
        "wo": init_dense(gen, h * hd, d, lead=lead, spec=("model", None)),
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
              q_chunk: Optional[int] = None, model=None) -> torch.Tensor:
    """Full-sequence attention.  x: (B,S,D); positions: (B,S).

    q_chunk: process queries in blocks of this size, so the materialized
    score tensor is (B,H,q_chunk,S) instead of (B,H,S,S).  ``model``: an
    agent group with a model axis: ``p`` is this rank's shard and the
    attention runs tensor-parallel (:func:`attention_kv`).
    """
    return attention_kv(p, cfg, x, positions, mode, prefix_len, q_chunk,
                        model)[0]


def attention_kv(p, cfg: AttnConfig, x, positions, mode: str = "causal",
                 prefix_len: int = 0, q_chunk: Optional[int] = None,
                 model=None):
    """:func:`attention`'s output and the keys (rotated) and values it
    attended over, (B, S, Hk, hd) each: what a prefill caches.

    Under ``model`` (a group whose ``model_size`` M > 1) the heads are
    sharded as the reference's specs say (:func:`repro_torch.nn.
    tensor_parallel.local_heads`): ``wq``, ``wk`` and ``wv``
    column-parallel, whole q heads a shard, ``wo`` row-parallel.  With
    whole kv heads a shard (``hk % M == 0``) the attention runs over the
    rank's heads (rotary, bias and window are head-local).  Otherwise each
    rank holds a slice of a kv head's columns: k and v are gathered over
    the model axis (one all-gather), the rank keeps the kv head its q
    heads share and rotates it whole (rotary pairs channel i with i +
    hd / 2, across the split).  k and v are the ones the rank attended
    over."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    heads = None
    if model is not None:
        heads = TP.local_heads(h, hk, model)
        h, hk = heads.q, heads.kv
        x = TP.copy_to_model(x, model)
    g = h // hk
    q = _split_heads(dense(p["wq"], x), h, hd)
    k, v = dense(p["wk"], x), dense(p["wv"], x)
    if heads is not None and heads.gathered:
        # one gather of both; every rank reads its own q heads of the
        # gathered kv head, so the gradient is summed before the slice
        kv = TP.copy_to_model(TP.gather_from_model(torch.stack([k, v]),
                                                   model), model)
        lo = heads.kv_head * hd
        k, v = kv[0, ..., lo:lo + hd], kv[1, ..., lo:lo + hd]
    k, v = _split_heads(k, hk, hd), _split_heads(v, hk, hd)
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

    out = _chunked(attend_block, q, s, q_chunk).reshape(b, s, h * hd)
    if model is not None:
        return TP.row_dense(p["wo"], out, model), k, v
    return dense(p["wo"], out), k, v


def _chunked(attend_block, q, s: int, q_chunk: Optional[int]):
    """``attend_block(q_blk, offset, blk_len)`` over query blocks of
    ``q_chunk`` (axis 1) when they tile ``s``, else over all of ``q``."""
    if q_chunk and s > q_chunk and s % q_chunk == 0:
        return torch.cat([attend_block(q[:, i: i + q_chunk], i, q_chunk)
                          for i in range(0, s, q_chunk)], dim=1)
    return attend_block(q, 0, s)


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


def _full_cache_mask(t: int, pos: int, window: Optional[int], device):
    """(t,) keys a decode step at ``pos`` attends to in a full cache: up to
    ``pos``, and within the window when there is one (module docstring)."""
    ki = torch.arange(t, device=device)
    mask = ki <= pos
    if window is not None:
        mask = mask & (ki > pos - window)
    return mask


def _write_slot(cache, key: str, slot: int, new):
    """cache[key][:, slot] = new[:, 0], in place; ``slot`` must lie in the
    cache."""
    t = cache[key].shape[1]
    if not 0 <= slot < t:
        raise IndexError(f"decode position {slot} is outside the {t}-slot "
                         "cache; grow the cache first")
    cache[key][:, slot] = new[:, 0].to(cache[key].dtype)


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
    _write_slot(cache, "k", slot, k_new)
    _write_slot(cache, "v", slot, v_new)

    scores = _scaled(_gqa_scores(q, k.to(x.dtype)), hd)   # (B,Hk,G,1,T)
    if windowed:
        pos_ids = cache["positions"]
        pos_ids[:, slot] = pos
        valid = (pos_ids <= pos) & (pos_ids >= 0)
        if cfg.window is not None:
            valid = valid & (pos_ids > pos - cfg.window)
        mask = valid[:, None, None, None, :]
    else:
        mask = _full_cache_mask(t, pos, cfg.window, x.device)[
            None, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, v.to(x.dtype)).reshape(b, 1, h * hd)
    return dense(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: MLAConfig, lead=()):
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wdq": init_dense(gen, cfg.d_model, cfg.q_lora_rank, lead=lead,
                          spec=(None, None)),
        "q_norm": init_rmsnorm(gen, cfg.q_lora_rank, lead=lead),
        "wuq": init_dense(gen, cfg.q_lora_rank, h * qk, lead=lead),
        "wdkv": init_dense(gen, cfg.d_model,
                           cfg.kv_lora_rank + cfg.qk_rope_dim, lead=lead,
                           spec=(None, None)),
        "kv_norm": init_rmsnorm(gen, cfg.kv_lora_rank, lead=lead),
        "wuk": init_dense(gen, cfg.kv_lora_rank, h * cfg.qk_nope_dim,
                          lead=lead),
        "wuv": init_dense(gen, cfg.kv_lora_rank, h * cfg.v_head_dim,
                          lead=lead),
        "wo": init_dense(gen, h * cfg.v_head_dim, cfg.d_model, lead=lead,
                         spec=("model", None)),
    }


def _mla_heads(cfg: MLAConfig, model) -> int:
    """The heads a rank computes: all of them, or under ``model`` its
    ``n_heads / M`` whole heads (``wuq``, ``wuk`` and ``wuv`` are
    column-parallel by heads, ``wo`` row-parallel)."""
    if model is None:
        return cfg.n_heads
    return TP.local_heads(cfg.n_heads, cfg.n_heads, model).q


def _mla_qkv(p, cfg: MLAConfig, x, positions, model=None):
    """Shared q / latent computation.  Returns q_nope, q_rope (B,S,H,*),
    ckv (B,S,dc) and krope (B,S,dr).  Under ``model`` the latents (``wdq``,
    ``wdkv`` and the norms are replicated) are every rank's, q its heads
    and krope copied in front of the rank's heads."""
    b, s, _ = x.shape
    h = _mla_heads(cfg, model)
    cq = rmsnorm(p["q_norm"], dense(p["wdq"], x))
    if model is not None:
        cq = TP.copy_to_model(cq, model)
    q = dense(p["wuq"], cq).reshape(b, s, h, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.qk_rope_dim, cfg.rope_theta)
    dkv = dense(p["wdkv"], x)
    ckv = rmsnorm(p["kv_norm"], dkv[..., : cfg.kv_lora_rank])
    krope = dkv[..., cfg.kv_lora_rank:][:, :, None, :]   # (B,S,1,dr)
    krope = apply_rope(krope, positions, cfg.qk_rope_dim, cfg.rope_theta)
    krope = krope[:, :, 0, :]
    if model is not None:
        krope = TP.copy_to_model(krope, model)
    return q_nope, q_rope, ckv, krope


def _mla_kv(p, cfg: MLAConfig, ckv, model=None):
    """The per-head keys (no rotary part) and values of a latent
    (B,T,dc): all heads, or under ``model`` the rank's."""
    b, h = ckv.shape[0], _mla_heads(cfg, model)
    if model is not None:
        ckv = TP.copy_to_model(ckv, model)
    k_nope = dense(p["wuk"], ckv).reshape(b, -1, h, cfg.qk_nope_dim)
    v = dense(p["wuv"], ckv).reshape(b, -1, h, cfg.v_head_dim)
    return k_nope, v


def _mla_probs(cfg: MLAConfig, q_nope, q_rope, k_nope, krope, mask, dtype):
    """Softmax probabilities (B,H,S,T) in ``dtype``: the two score
    products added in the activations' dtype, then scaled in f32."""
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, krope))
    scores = _scaled(scores, cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = scores + _mask_bias(mask, scores.dtype)
    return torch.softmax(scores, dim=-1).to(dtype)


def _mla_out(p, out, model):
    if model is not None:
        return TP.row_dense(p["wo"], out, model)
    return dense(p["wo"], out)


def _mla_attend(p, cfg: MLAConfig, q_nope, q_rope, ckv, krope, mask, dtype,
                model=None):
    """q_*: (B,S,H,*); ckv: (B,T,dc); krope: (B,T,dr) -> (B,S,D)."""
    b, s = q_nope.shape[:2]
    k_nope, v = _mla_kv(p, cfg, ckv, model)
    probs = _mla_probs(cfg, q_nope, q_rope, k_nope, krope, mask, dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, -1)
    return _mla_out(p, out, model)


def mla_attention(p, cfg: MLAConfig, x, positions,
                  q_chunk: Optional[int] = None) -> torch.Tensor:
    """Causal MLA over x: (B,S,D); q_chunk as in :func:`attention`."""
    return mla_attention_latent(p, cfg, x, positions, q_chunk)[0]


def mla_attention_latent(p, cfg: MLAConfig, x, positions,
                         q_chunk: Optional[int] = None, model=None):
    """:func:`mla_attention`'s output and the latent ``ckv`` and rotated
    ``krope`` it attended over: what a prefill caches.  ``model``: a group
    with a model axis, ``p`` this rank's shard (:func:`_mla_qkv`)."""
    b, s, _ = x.shape
    q_nope, q_rope, ckv, krope = _mla_qkv(p, cfg, x, positions, model)
    if not (q_chunk and s > q_chunk and s % q_chunk == 0):
        mask = make_mask(s, s, "causal", device=x.device)
        return (_mla_attend(p, cfg, q_nope, q_rope, ckv, krope, mask,
                            x.dtype, model), ckv, krope)
    # chunked queries: expand k / v once, then one score block at a time
    k_nope, v = _mla_kv(p, cfg, ckv, model)

    def attend_block(qs, offset, blk_len):
        qn, qr = qs[..., : cfg.qk_nope_dim], qs[..., cfg.qk_nope_dim:]
        mask = make_mask(blk_len, s, "causal", q_offset=offset,
                         device=x.device)
        probs = _mla_probs(cfg, qn, qr, k_nope, krope, mask, x.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    out = _chunked(attend_block, torch.cat([q_nope, q_rope], dim=-1), s,
                   q_chunk).reshape(b, s, -1)
    return _mla_out(p, out, model), ckv, krope


def init_mla_cache(batch: int, seq: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    return {"ckv": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype,
                                 device=device)}


def mla_decode(p, cfg: MLAConfig, x, cache: Dict[str, Any], pos):
    """One-token MLA decode: write the token's latent at ``pos`` (in
    place) and attend over [0, pos]."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(p, cfg, x, positions)
    _write_slot(cache, "ckv", pos, ckv_new)
    _write_slot(cache, "krope", pos, krope_new)
    ckv, krope = cache["ckv"], cache["krope"]
    mask = _full_cache_mask(ckv.shape[1], pos, None, x.device)[None, :]
    out = _mla_attend(p, cfg, q_nope, q_rope, ckv.to(x.dtype),
                      krope.to(x.dtype), mask, x.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention (seamless-m4t enc-dec)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: AttnConfig, lead=()):
    return init_attention(gen, cfg, lead=lead)


def _cross_heads(cfg: AttnConfig, model) -> Tuple[int, int]:
    """The (q, kv) heads a rank computes: all of them, or under ``model``
    its whole heads of the column split (a kv head split below a rank is
    refused: the encoder-decoder's kv heads are its q heads)."""
    if model is None:
        return cfg.n_heads, cfg.n_kv_heads
    heads = TP.local_heads(cfg.n_heads, cfg.n_kv_heads, model)
    if heads.gathered:
        raise ValueError(
            f"tensor-parallel cross-attention splits whole kv heads: "
            f"{cfg.n_kv_heads} kv heads over a model axis of "
            f"{model.model_size}")
    return heads.q, heads.kv


def _cross_kv(p, cfg: AttnConfig, enc_out, model=None):
    """The encoder's keys and values (B,T,Hk,hd): all kv heads, or under
    ``model`` the rank's (``wk`` / ``wv`` column-parallel on ``enc_out``
    behind :func:`repro_torch.nn.tensor_parallel.copy_to_model`, so
    ``enc_out``'s gradient sums every rank's part)."""
    hk, hd = _cross_heads(cfg, model)[1], cfg.head_dim
    if model is not None:
        enc_out = TP.copy_to_model(enc_out, model)
    k = _split_heads(dense(p["wk"], enc_out), hk, hd)
    v = _split_heads(dense(p["wv"], enc_out), hk, hd)
    return k, v


def _cross_attend(p, cfg: AttnConfig, x, k, v, q_chunk=None, model=None):
    """Unmasked attention of decoder states x (B,S,D) over encoder keys
    and values (B,T,Hk,hd); under ``model`` ``wq`` column-parallel and
    ``wo`` row-parallel over the rank's heads."""
    b, s, _ = x.shape
    (h, hk), hd = _cross_heads(cfg, model), cfg.head_dim
    if model is not None:
        x = TP.copy_to_model(x, model)
    q = _split_heads(dense(p["wq"], x), h, hd).reshape(b, s, hk, h // hk, hd)

    def attend_block(q_blk, offset, blk_len):
        del offset, blk_len
        scores = _scaled(_gqa_scores(q_blk, k), hd)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return _gqa_out(probs, v)

    out = _chunked(attend_block, q, s, q_chunk).reshape(b, s, h * hd)
    if model is not None:
        return TP.row_dense(p["wo"], out, model)
    return dense(p["wo"], out)


def cross_attention(p, cfg: AttnConfig, x, enc_out,
                    q_chunk: Optional[int] = None, model=None
                    ) -> torch.Tensor:
    """x: (B,S,D) decoder states; enc_out: (B,T,D).  No mask (full).
    ``model``: a group with a model axis, ``p`` this rank's shard."""
    k, v = _cross_kv(p, cfg, enc_out, model)
    return _cross_attend(p, cfg, x, k, v, q_chunk, model)


def make_cross_cache(p, cfg: AttnConfig, enc_out, dtype=torch.bfloat16):
    k, v = _cross_kv(p, cfg, enc_out)
    return {"k": k.to(dtype), "v": v.to(dtype)}


def cross_attention_decode(p, cfg: AttnConfig, x, cross_cache):
    """One decoder token over the cached encoder keys and values."""
    return _cross_attend(p, cfg, x, cross_cache["k"].to(x.dtype),
                         cross_cache["v"].to(x.dtype))
