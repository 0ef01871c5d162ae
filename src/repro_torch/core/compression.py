"""Communication compression operators (paper Definition 3).

A rho-compressor is a (possibly randomized, possibly biased) map C with
E || C(x) - x ||^2 <= (1 - rho) ||x||^2.  Ported from
``src/repro/core/compression.py``: ``identity``, ``random_k`` (paper
Example 1), ``top_k`` (paper Example 2), ``block_top_k`` (top-k inside each
2048-element block), ``qsgd`` (the scaled stochastic quantizer), ``sign``
(the l1-scaled sign) and ``low_rank`` (a PowerSGD-style projection).  Under
``wire="packed_bits"`` the codec of :mod:`repro_torch.core.wire_formats`
stands in for ``fn``; the compressor still gives gamma its ``rho``.

A compressor here works on *rows*: ``fn(gen, rows)`` compresses each row
of a ``(n, d)`` tensor independently, which is how the comm-round engine
applies it to one agent-stacked leaf at a time (every agent compresses its
own increment).  Randomness comes from an explicit ``torch.Generator``; a
random compressor also takes ``group=`` (an agent group, one agent a rank:
the rows are this rank's, and it draws the one-card shape and keeps their
rows, :func:`repro_torch.core.agents.local_rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import ops
from .agents import local_rows
from .wire_formats import PACK_BLOCK

__all__ = ["Compressor", "identity", "random_k", "top_k", "block_top_k",
           "qsgd", "low_rank", "sign", "make_compressor"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A rho-compression operator (Definition 3).

    fn: ``(gen, rows, **kw) -> compressed rows`` (same shape and dtype).
    deterministic: True when ``fn`` ignores the generator.
    bits_per_element: wire bits per transmitted value (index bits are added
    by :meth:`wire_bits`).
    """

    name: str
    rho: float
    fn: Callable[..., torch.Tensor]
    deterministic: bool = False
    bits_per_element: int = 32

    def __call__(self, gen: Optional[torch.Generator], rows: torch.Tensor,
                 **kw) -> torch.Tensor:
        return self.fn(gen, rows, **kw)

    def wire_bits(self, d: int) -> float:
        """Estimated bits on the wire for one compressed d-vector."""
        if self.name == "identity":
            return 32.0 * d
        if self.name == "sign":
            return 1.0 * d + 32.0   # one bit a coordinate + the f32 scale
        # sparse schemes: value + log2(d) index bits per kept element
        k = max(int(round(self.rho * d)), 1)
        return k * (self.bits_per_element + float(np.ceil(np.log2(max(d, 2)))))


def _operand(group, given, shape, draw):
    """A random operand of a compressor: ``given`` (injected, at the
    one-card shape) or drawn, under an agent ``group`` this rank's rows
    of either."""
    if given is None:
        return local_rows(group, shape, draw)
    return given if group is None else group.rows(given, shape[0])


def _identity(gen, rows):
    del gen
    return rows


def identity() -> Compressor:
    return Compressor("identity", 1.0, _identity, deterministic=True)


def random_k(frac: float) -> Compressor:
    """Paper Example 1: keep each coordinate w.p. ``frac`` (biased, no
    rescale).  ``mask=`` injects the keep-mask in place of the generator's
    draw (the parity tests hand over the reference's Bernoulli mask)."""

    def fn(gen, rows, mask=None, group=None):
        mask = _operand(group, mask, rows.shape, lambda shape: torch.rand(
            shape, generator=gen, device=rows.device) < frac)
        return torch.where(mask, rows, torch.zeros_like(rows))

    return Compressor(f"random_k({frac})", float(frac), fn)


def top_k(frac: float) -> Compressor:
    """Paper Example 2: keep the k = frac*d largest-magnitude coordinates of
    each row, k = max(round(frac * d), 1) with Python's ``round``.

    Ties at the k-th magnitude go to the lowest index, as in
    ``jax.lax.top_k``: a stable descending sort keeps equal magnitudes in
    index order (``torch.topk`` promises no order among ties).
    """

    def fn(gen, rows):
        del gen
        k = min(max(int(round(frac * rows.shape[-1])), 1), rows.shape[-1])
        return _keep_top(rows, k)

    return Compressor(f"top_k({frac})", float(frac), fn, deterministic=True)


def _keep_top(rows, k: int):
    """Zero all but the k largest magnitudes along the last axis, ties to
    the lowest index (a stable descending sort).  The whole-row top-k: the
    block_topk kernel takes 2048-element windows only."""
    idx = torch.sort(rows.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.zeros_like(rows).scatter_(-1, idx,
                                           torch.gather(rows, -1, idx))


def block_top_k(frac: float) -> Compressor:
    """Top-k inside each 2048-element window of a row (the row padded with
    zeros to whole windows): k_b = max(round(frac * 2048), 1) per window,
    ties to the lowest index as ``jax.lax.top_k``.  Still a Definition-3
    compressor with rho = frac (window energies add).

    Every window of a leaf goes through one ``ops.block_topk`` call (one
    kernel launch a compressed leaf on the card).  The window is the
    kernel's, so the reference's ``block`` argument (2048 by default, set
    by no caller) has no counterpart."""

    def fn(gen, rows):
        del gen
        d = rows.shape[-1]
        windows = torch.nn.functional.pad(
            rows, (0, (-d) % PACK_BLOCK)).reshape(-1, PACK_BLOCK).contiguous()
        out = ops.block_topk(windows, max(int(round(frac * PACK_BLOCK)), 1))
        return out.reshape(*rows.shape[:-1], -1)[..., :d]

    return Compressor(f"block_top_k({frac},{PACK_BLOCK})", float(frac), fn,
                      deterministic=True)


def qsgd(levels: int = 16) -> Compressor:
    """Scaled stochastic quantizer over each whole row: QSGD with ``levels``
    levels is unbiased with relative variance omega <= min(d / s^2,
    sqrt(d) / s), so dividing by (1 + omega) makes it a rho = 1/(1 + omega)
    contraction.  The registry's rho is the bound at d ~ 1e6, as in the
    reference.  ``noise=`` injects the U[0, 1) draws of the stochastic
    rounding in place of the generator's (the parity tests hand over the
    reference's uniforms)."""

    def fn(gen, rows, noise=None, group=None):
        d = rows.shape[-1]
        noise = _operand(group, noise, rows.shape, lambda shape: torch.rand(
            shape, generator=gen, device=rows.device))
        norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True) + 1e-30
        y = rows.abs() / norm * levels
        lo = torch.floor(y)
        # tensor divisors: PyTorch's CUDA division by a scalar multiplies
        # by its reciprocal, which is not the f32 quotient
        q = (lo + (noise < y - lo).to(rows.dtype)) / torch.full_like(
            lo, levels)
        omega = min(np.sqrt(d) / levels, d / levels ** 2)
        out = torch.sign(rows) * q * norm / torch.full_like(norm, 1.0 + omega)
        return out.to(rows.dtype)

    omega_typ = np.sqrt(1e6) / levels
    return Compressor(f"qsgd({levels})", float(1.0 / (1.0 + omega_typ)), fn,
                      bits_per_element=int(np.ceil(np.log2(levels + 1))) + 1)


def low_rank(rank: int = 2, power_iters: int = 1) -> Compressor:
    """PowerSGD-style rank-r compressor: each row is zero-padded and
    reshaped to a near-square (m, n) matrix M, ``power_iters`` subspace
    iterations from a Gaussian sketch give an orthonormal Q, and the row
    becomes ``(M Q) Q^T``, in f32.  A projection contracts, so Definition 3
    holds with a data-dependent rho; the registry reports 0, and a derived
    gamma is then refused (pass ``gamma=``).

    The sketch is the compressor's random draw: ``(rows, n, r)`` N(0, 1)
    from ``gen``, or given as ``sketch=`` (the parity tests hand over the
    reference's).  The projection does not depend on the signs of Q's
    columns, so any QR factorization gives the same result."""

    def fn(gen, rows, sketch=None, group=None):
        d = rows.shape[-1]
        m = int(np.ceil(np.sqrt(d)))
        n = int(np.ceil(d / m))
        r = min(rank, m, n)
        flat = rows.reshape(-1, d).to(torch.float32)
        mat = torch.nn.functional.pad(flat, (0, m * n - d)).reshape(-1, m, n)
        sketch = _operand(group, sketch, (mat.shape[0], n, r),
                          lambda shape: torch.randn(shape, generator=gen,
                                                    device=rows.device))
        q = sketch.to(torch.float32).reshape(mat.shape[0], n, r)
        for _ in range(power_iters):
            p_ = torch.linalg.qr(mat @ q).Q
            q = mat.transpose(-1, -2) @ p_
        q_orth = torch.linalg.qr(q).Q
        approx = (mat @ q_orth) @ q_orth.transpose(-1, -2)
        return approx.reshape(-1, m * n)[:, :d].reshape(rows.shape).to(
            rows.dtype)

    return Compressor(f"low_rank({rank})", 0.0, fn)


def sign() -> Compressor:
    """l1-scaled sign compressor: C(x) = (||x||_1 / d) sign(x) per row, in
    f32: one bit a coordinate plus one f32 scale on the wire.  Definition 3
    holds with rho(x) = ||x||_1^2 / (d ||x||_2^2) >= 1 / d; the registry
    reports 0, as for ``low_rank``."""

    def fn(gen, rows):
        del gen
        flat = rows.to(torch.float32)
        scale = torch.mean(torch.abs(flat), dim=-1, keepdim=True)
        return (scale * torch.sign(flat)).to(rows.dtype)

    return Compressor("sign", 0.0, fn, deterministic=True, bits_per_element=1)


_REGISTRY = {"identity": identity, "random_k": random_k, "top_k": top_k,
             "block_top_k": block_top_k, "qsgd": qsgd, "low_rank": low_rank,
             "sign": sign}


def make_compressor(name: str, **kwargs) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
