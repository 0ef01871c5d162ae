"""Linear-recurrence token mixers (``src/repro/nn/ssm.py``): RWKV6 (Finch)
and Mamba2 (SSD).

A prefill whose length is a multiple of the chunk length runs the chunked
scan: ``kernels.ops.rwkv6_scan`` (chunk :data:`RWKV_CHUNK`, the
hand-written ``rwkv6_chunk`` kernel on the card) or ``kernels.ops.ssd_scan``
(chunk :data:`SSD_CHUNK`, the ``ssd_chunk`` kernel); any other length, and
every decode step, runs the exact per-token recurrence, as the reference
does.  ``plain_scan=True`` takes the chunked scan's plain PyTorch form
(``kernels.ref.rwkv6_chunk_ref`` / ``ssd_chunk_ref``) on any device: the
training loss passes it, since the kernels have no backward and the
reference trains through its jnp chunked forms.  RWKV6's log w is clamped
to [LOGW_MIN, LOGW_MAX] so that the chunk's cumulative log-decay stays
within f32's exp range (|la| <= 80 at chunk 16);
Mamba2's decay is a scalar per step and head, so its chunk needs no clamp.

RWKV6 recurrence (head dim N):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
Mamba2 / SSD recurrence (head dim P, state N):
    h_t = a_t h_{t-1} + (dt_t x_t) B_t^T
    y_t = h_t C_t + D x_t
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..kernels import ops, ref
from ..kernels.ref import RWKV_CHUNK, SSD_CHUNK
from .module import dense, init_dense, init_layernorm, layernorm, param

__all__ = ["Rwkv6Config", "init_rwkv6_block", "rwkv6_block", "rwkv6_decode",
           "init_rwkv6_state", "rwkv_scan_ref", "LOGW_MIN", "LOGW_MAX",
           "RWKV_CHUNK", "Mamba2Config", "init_mamba2_block",
           "init_mamba2_state", "mamba2_block", "mamba2_decode",
           "ssd_scan_ref", "SSD_CHUNK"]

LOGW_MIN, LOGW_MAX = -5.0, -1e-6
rwkv_scan_ref = ref.rwkv6_scan_ref
ssd_scan_ref = ref.ssd_scan_ref

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Rwkv6Config:
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    d_ff: int = 0           # channel-mix hidden (0 -> 3.5x d_model)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or int(3.5 * self.d_model)


def init_rwkv6_block(gen: torch.Generator, cfg: Rwkv6Config, lead=()):
    """One block's parameters (or a stack of them, ``lead=(n,)``), with the
    reference's shapes and scales."""
    d, h, n = cfg.d_model, cfg.n_heads, cfg.head_dim
    f = cfg.ffn_dim
    return {
        # --- time mix (attention analogue) ---
        "mu": param(gen, (*lead, 5, d), 0.5, mode="uniform"),
        "wr": init_dense(gen, d, d, lead=lead),
        "wk": init_dense(gen, d, d, lead=lead),
        "wv": init_dense(gen, d, d, lead=lead),
        "wg": init_dense(gen, d, d, lead=lead),
        "w0": param(gen, (*lead, d), 0.5, mode="uniform"),
        "w_lora_a": init_dense(gen, d, cfg.decay_lora, lead=lead),
        "w_lora_b": init_dense(gen, cfg.decay_lora, d, scale=0.01,
                               lead=lead),
        "u": param(gen, (*lead, h, n), 0.3, mode="uniform"),
        "out_norm": init_layernorm(gen, d, lead=lead),
        "wo": init_dense(gen, d, d, lead=lead),
        # --- channel mix ---
        "mu_c": param(gen, (*lead, 2, d), 0.5, mode="uniform"),
        "ck": init_dense(gen, d, f, lead=lead),
        "cr": init_dense(gen, d, d, lead=lead),
        "cv": init_dense(gen, f, d, lead=lead),
    }


def _token_shift(x, shift_state):
    """x: (B,S,D); shift_state: (B,D) = last token of previous segment."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: exact for every x
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rwkv_rkvwg(p, cfg: Rwkv6Config, x, prev):
    """Projections with per-channel token-shift lerp (static mu)."""
    mu = p["mu"].to(x.dtype)  # (5, d) for r,k,v,w,g
    mix = [x + (prev - x) * mu[i] for i in range(5)]
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.head_dim
    r = dense(p["wr"], mix[0]).reshape(b, s, h, n)
    k = dense(p["wk"], mix[1]).reshape(b, s, h, n)
    v = dense(p["wv"], mix[2]).reshape(b, s, h, n)
    logw_raw = p["w0"].to(_F32) + dense(
        p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], mix[3]))).to(_F32)
    # data-dependent decay w = exp(-softplus(.)) in (0,1); clamp for chunk form
    logw = torch.clamp(-_softplus(-logw_raw), LOGW_MIN, LOGW_MAX)
    logw = logw.reshape(b, s, h, n)
    g = torch.nn.functional.silu(dense(p["wg"], mix[4]))
    return r, k, v, logw, g


def init_rwkv6_state(batch: int, cfg: Rwkv6Config, dtype=_F32, device=None):
    """Zero recurrent state on ``device`` (cuda unless given)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    h, n, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"S": torch.zeros((batch, h, n, n), dtype=dtype, device=device),
            "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv6_block(p, cfg: Rwkv6Config, x, state: Optional[Dict] = None,
                chunked: bool = True, plain_scan: bool = False):
    """Full time-mix + channel-mix over a sequence.  x: (B,S,D).

    Returns (y, final_state).  The chunked scan runs when ``chunked`` and S
    is a multiple of RWKV_CHUNK (and above 1), through the kernel's wrapper
    or, under ``plain_scan``, its plain form; otherwise the recurrence.
    """
    b, s, d = x.shape
    if state is None:
        state = init_rwkv6_state(b, cfg, device=x.device)
    prev = _token_shift(x, state["shift_t"].to(x.dtype))
    r, k, v, logw, g = _rwkv_rkvwg(p, cfg, x, prev)
    u = p["u"]
    if chunked and s % RWKV_CHUNK == 0 and s > 1:
        chunk_scan = ref.rwkv6_chunk_ref if plain_scan else ops.rwkv6_scan
        o, s_fin = chunk_scan(r, k, v, logw, u, state["S"])
    else:
        o, s_fin = rwkv_scan_ref(r, k, v, logw, u, state["S"])
    o = o.reshape(b, s, d).to(x.dtype)
    o = layernorm(p["out_norm"], o) * g
    y = x + dense(p["wo"], o)

    # channel mix
    prev_c = _token_shift(y, state["shift_c"].to(x.dtype))
    mu_c = p["mu_c"].to(x.dtype)
    xr = y + (prev_c - y) * mu_c[0]
    xk = y + (prev_c - y) * mu_c[1]
    hidden = torch.square(torch.relu(dense(p["ck"], xk)))
    out = torch.sigmoid(dense(p["cr"], xr)) * dense(p["cv"], hidden)
    y2 = y + out
    new_state = {"S": s_fin, "shift_t": x[:, -1, :].to(_F32),
                 "shift_c": y[:, -1, :].to(_F32)}
    return y2, new_state


def rwkv6_decode(p, cfg: Rwkv6Config, x, state):
    """One-token step.  x: (B,1,D)."""
    return rwkv6_block(p, cfg, x, state, chunked=False)


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2_block(gen: torch.Generator, cfg: Mamba2Config, lead=()):
    """One block's parameters (or a stack, ``lead=(n,)``), with the
    reference's shapes and scales."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    conv_ch = di + 2 * n
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "w_in": init_dense(gen, d, 2 * di + 2 * n + h, lead=lead),
        "conv_w": param(gen, (*lead, cfg.d_conv, conv_ch),
                        1.0 / cfg.d_conv ** 0.5),
        "conv_b": param(gen, (*lead, conv_ch), 0.0, mode="zeros"),
        "a_log": param(gen, (*lead, h), 0.5, mode="uniform"),
        "dt_bias": param(gen, (*lead, h), 0.5, mode="uniform"),
        "d_skip": param(gen, (*lead, h), 1.0, mode="ones"),
        "out_norm": init_layernorm(gen, di, lead=lead),
        "w_out": init_dense(gen, di, d, lead=lead),
    }


def _ssd_chunk_scan(xh, bmat, cmat, dla, h0, plain_scan: bool = False):
    """The exact chunked SSD (``repro.nn.ssm._ssd_chunk_scan``): the
    ``ssd_chunk`` kernel on the card, its plain version on the CPU, or the
    plain version on any device under ``plain_scan``.

    xh: (B,S,H,P) dt-scaled inputs; bmat/cmat: (B,S,N); dla: (B,S,H)
    *per-step* log-decay (log a_t); h0: (B,H,P,N).  Returns (y, h_final).
    """
    if plain_scan:
        return ref.ssd_chunk_ref(xh, bmat, cmat, dla, h0)
    return ops.ssd_scan(xh, bmat, cmat, dla, h0)


def init_mamba2_state(batch: int, cfg: Mamba2Config, dtype=_F32,
                      device=None):
    """Zero SSM state and conv tail on ``device`` (cuda unless given)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    return {"h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


def _causal_conv(seq, w, b, conv_state):
    """Depthwise causal conv1d.  seq: (B,S,C); w: (K,C); returns (y,
    new_state)."""
    k = w.shape[0]
    padded = torch.cat([conv_state.to(seq.dtype), seq], dim=1)
    out = padded[:, 0: seq.shape[1], :] * w[0].to(seq.dtype)
    for i in range(1, k):
        out = out + padded[:, i: i + seq.shape[1], :] * w[i].to(seq.dtype)
    new_state = padded[:, -(k - 1):, :] if k > 1 else conv_state
    return out + b.to(seq.dtype), new_state


def mamba2_block(p, cfg: Mamba2Config, x, state: Optional[Dict] = None,
                 chunked: bool = True, plain_scan: bool = False):
    """x: (B,S,D) -> (y, new_state).  The chunked scan runs when
    ``chunked`` and S is a multiple of SSD_CHUNK (and above 1), through the
    kernel's wrapper or, under ``plain_scan``, its plain form; otherwise
    the recurrence."""
    b, s, d = x.shape
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    if state is None:
        state = init_mamba2_state(b, cfg, device=x.device)
    zxbcdt = dense(p["w_in"], x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * n]
    dt_raw = zxbcdt[..., -h:]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xbc = torch.nn.functional.silu(xbc)
    xin = xbc[..., :di].reshape(b, s, h, pd)
    bmat = xbc[..., di: di + n]
    cmat = xbc[..., di + n:]
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))   # (B,S,H)
    a = -torch.exp(p["a_log"].to(_F32))                        # (H,) negative
    dla = dt * a[None, None, :]                                # per-step log a
    xh = xin.to(_F32) * dt[..., None]
    if chunked and s % SSD_CHUNK == 0 and s > 1:
        y, h_fin = _ssd_chunk_scan(xh, bmat, cmat, dla, state["h"],
                                   plain_scan)
    else:
        y, h_fin = ssd_scan_ref(xh, bmat, cmat, dla, state["h"])
    y = y + xin.to(_F32) * p["d_skip"].to(_F32)[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = layernorm(p["out_norm"], y * torch.nn.functional.silu(z))
    out = dense(p["w_out"], y)
    new_state = {"h": h_fin, "conv": conv_state.to(_F32)}
    return out, new_state


def mamba2_decode(p, cfg: Mamba2Config, x, state):
    """One-token step.  x: (B,1,D)."""
    return mamba2_block(p, cfg, x, state, chunked=False)
