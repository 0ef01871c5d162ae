"""Communication compression operators (paper Definition 3).

A rho-compressor is a (possibly randomized, possibly biased) map C with
E || C(x) - x ||^2 <= (1 - rho) ||x||^2.  This slice ports ``identity``,
``random_k`` (paper Example 1) and ``top_k`` (paper Example 2) from
``src/repro/core/compression.py``; the other four wait (ROADMAP queue 1).

A compressor here works on *rows*: ``fn(gen, rows)`` compresses each row
of a ``(n, d)`` tensor independently, which is how the comm-round engine
applies it to one agent-stacked leaf at a time (every agent compresses its
own increment).  Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["Compressor", "identity", "random_k", "top_k", "make_compressor"]


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
        # sparse schemes: value + log2(d) index bits per kept element
        k = max(int(round(self.rho * d)), 1)
        return k * (self.bits_per_element + float(np.ceil(np.log2(max(d, 2)))))


def _identity(gen, rows):
    del gen
    return rows


def identity() -> Compressor:
    return Compressor("identity", 1.0, _identity, deterministic=True)


def random_k(frac: float) -> Compressor:
    """Paper Example 1: keep each coordinate w.p. ``frac`` (biased, no
    rescale).  ``mask=`` injects the keep-mask in place of the generator's
    draw (the parity tests hand over the reference's Bernoulli mask)."""

    def fn(gen, rows, mask=None):
        if mask is None:
            mask = torch.rand(rows.shape, generator=gen,
                              device=rows.device) < frac
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
        idx = torch.sort(rows.abs(), dim=-1, descending=True,
                         stable=True).indices[..., :k]
        return torch.zeros_like(rows).scatter_(
            -1, idx, torch.gather(rows, -1, idx))

    return Compressor(f"top_k({frac})", float(frac), fn, deterministic=True)


_REGISTRY = {"identity": identity, "random_k": random_k, "top_k": top_k}
_LATER = ("block_top_k", "low_rank", "sign", "qsgd")


def make_compressor(name: str, **kwargs) -> Compressor:
    if name in _LATER:
        raise ValueError(
            f"compressor {name!r} is not ported yet (ROADMAP queue 1 item 2); "
            f"this slice has {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
