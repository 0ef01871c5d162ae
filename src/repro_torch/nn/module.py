"""Parameter initialisers and the basic layers (``src/repro/nn/module.py``).

Parameters are plain nested dicts of tensors.  Every ``init_*`` draws from
an explicit ``torch.Generator`` on that generator's device, so a model at
full width is drawn on the card and never passes through host memory.
``lead`` prefixes each leaf's shape: ``lead=(n_layers,)`` draws a whole
stack of layers at once, the stacked ``(n_layers, ...)`` leaves the
reference builds with ``stack_inits``.  The draws are not the reference's
(its ``jax.random`` keys have no PyTorch counterpart); the tests carry the
reference's parameters across with :mod:`repro_torch.convert`.

The reference's sharding specs (``Px``, ``P``) are dropped: the port runs
on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["param", "init_dense", "dense", "init_embedding", "embedding",
           "init_rmsnorm", "rmsnorm", "init_layernorm", "layernorm",
           "rope_freqs", "apply_rope"]

_F32 = torch.float32


def param(gen: torch.Generator, shape: Sequence[int], scale: float = 1.0,
          dtype=_F32, mode: str = "normal") -> torch.Tensor:
    """``scale * N(0, 1)``, ``scale * U(-1, 1)``, zeros or ones, drawn on
    ``gen``'s device."""
    shape = tuple(shape)
    dev = gen.device
    if mode == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=dev).mul_(scale)
    if mode == "uniform":
        return torch.empty(shape, dtype=dtype, device=dev).uniform_(
            -1.0, 1.0, generator=gen).mul_(scale)
    if mode == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if mode == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    raise ValueError(mode)


def init_dense(gen, d_in: int, d_out: int, bias: bool = False,
               scale: Optional[float] = None, dtype=_F32, lead=()):
    scale = scale if scale is not None else 1.0 / d_in ** 0.5
    p = {"w": param(gen, (*lead, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = param(gen, (*lead, d_out), 0.0, dtype, mode="zeros")
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_embedding(gen, vocab: int, d: int, dtype=_F32, lead=()):
    return {"table": param(gen, (*lead, vocab, d), 0.02, dtype)}


def embedding(p, tokens: torch.Tensor, dtype=_F32) -> torch.Tensor:
    return p["table"][tokens].to(dtype)


def init_rmsnorm(gen, d: int, dtype=_F32, lead=()):
    return {"scale": param(gen, (*lead, d), dtype=dtype, mode="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(_F32)
    return out.to(x.dtype)


def init_layernorm(gen, d: int, dtype=_F32, lead=()):
    return {"scale": param(gen, (*lead, d), dtype=dtype, mode="ones"),
            "bias": param(gen, (*lead, d), dtype=dtype, mode="zeros")}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(_F32) + p["bias"].to(_F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings: full / partial ("2d", chatglm-style) rotary fraction.
# ---------------------------------------------------------------------------

def rope_freqs(rotary_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=_F32,
                                         device=device) / rotary_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` channels of the last axis.

    x: (..., seq, heads, head_dim); positions: (..., seq) integer.
    rotary_dim < head_dim gives partial rotary (chatglm3's "2d" RoPE).
    """
    hd = x.shape[-1]
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    freqs = rope_freqs(rotary_dim, theta, x.device)   # (rotary_dim/2,)
    ang = positions[..., None].to(_F32) * freqs        # (..., seq, rd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = rot[..., : rotary_dim // 2], rot[..., rotary_dim // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rotary_dim < hd:
        out = torch.cat([out, rest], dim=-1)
    return out
