"""The comm-round engine: compress -> accumulate -> fused update.

Every compressed decentralized method repeats one per-round pattern around
a buffer ``y`` with surrogate ``q`` and mixing mirror ``m``:

    c   =  C(y - q)          compress the increment        (the wire)
    q  +=  c                 surrogate accumulate
    m  +=  W c               mixing-mirror accumulate      (receive side)
    y'  =  f(y, m - q, ...)  algorithm-specific fused update

:class:`CommRound` owns that pattern (``src/repro/core/comm_round.py``).
Compression and mixing run per leaf; the update runs either leafwise
(``'ref'``) or over the flat tile planes of :mod:`repro_torch.kernels.flatten`
through the fused kernels of :mod:`repro_torch.kernels.ops` (``'kernel'``),
which touch every parameter once per round.

Backends: ``'kernel'`` (the plane path: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors), ``'ref'`` (leafwise PyTorch, the
numerical oracle) and ``'auto'`` (``'kernel'`` for CUDA tensors, ``'ref'``
for CPU ones, decided per call from the state's device).

This slice is f32 and dense-gossip only: bf16 planes, push-sum, CHOCO's
``gossip_apply``, ``shift`` and the codec wire formats wait (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..kernels import flatten as FL
from ..kernels import ops
from ..tree import tree_leaves, tree_map
from .compression import Compressor
from .gossip import MixFn, apply_mixer

__all__ = ["CommRound", "compress_stacked", "resolve_backend",
           "resolve_engine"]

_BACKENDS = ("kernel", "ref", "auto")


def resolve_backend(backend: str, device) -> str:
    """Resolve 'auto' for tensors on ``device``: the fused CUDA kernels for
    CUDA tensors, the leafwise reference for CPU ones."""
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "ref"
    if backend not in ("kernel", "ref"):
        raise ValueError(f"unknown comm-round backend {backend!r}; have "
                         f"{_BACKENDS}")
    return backend


def compress_stacked(comp: Compressor, gen: Optional[torch.Generator], tree):
    """Compress each agent's row of every leaf independently (every agent
    compresses its own increment, per leaf).  Leaves draw from ``gen`` in
    tree order."""
    return tree_map(
        lambda leaf: comp(gen, leaf.reshape(leaf.shape[0], -1))
        .reshape(leaf.shape), tree)


def resolve_engine(engine: Optional["CommRound"], mixer: Optional[MixFn] = None,
                   compressor: Optional[Compressor] = None,
                   backend: str = "auto") -> "CommRound":
    """Return ``engine`` or build one from the pieces -- never both."""
    if engine is not None:
        for what, given, owned in (("mixer", mixer, engine.mixer),
                                   ("compressor", compressor,
                                    engine.compressor)):
            if given is not None and given is not owned:
                raise ValueError(
                    f"both engine= and a conflicting {what} were given; the "
                    f"engine owns its {what}")
        return engine
    if compressor is None:
        raise ValueError("need either engine= or a compressor")
    return CommRound(compressor=compressor, mixer=mixer, backend=backend)


def _sub(y, q):
    return tree_map(lambda a, b: (a - b).to(b.dtype), y, q)


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One compressed communication round: compress -> accumulate -> update.

    compressor: the rho-compressor; also drives wire accounting.
    mixer: dense gossip executor ``tree -> W @ tree`` over the agent axis.
    backend: 'kernel' | 'ref' | 'auto'.
    overlap: issue both PORTER exchanges before either fused update; every
      value equals the sequential order's (bit-exact by construction).
    plane_dtype: declared storage dtype of the EF planes; f32 (or None) in
      this slice.
    """

    compressor: Compressor
    mixer: MixFn
    backend: str = "auto"
    overlap: bool = False
    plane_dtype: Any = None

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown comm-round backend {self.backend!r}; "
                             f"have {_BACKENDS}")
        if self.plane_dtype not in (None, torch.float32):
            raise ValueError(
                f"plane_dtype {self.plane_dtype} is not ported yet: this "
                "slice runs f32 planes only; bf16 EF planes with their "
                "stochastic-rounding writeback come with the sr_cast slice "
                "(ROADMAP queue 1 item 7)")

    def _use_kernel(self, tree) -> bool:
        device = tree_leaves(tree)[0].device
        return resolve_backend(self.backend, device) == "kernel"

    # -- the shared front half: compress + mix ------------------------------

    def compress(self, gen, delta):
        """c = C(delta), per agent row of every leaf."""
        return compress_stacked(self.compressor, gen, delta)

    def exchange(self, gen, y, q, t=None) -> Tuple[Any, Any]:
        """Returns ``(c, wc)``: ``c = C(y - q)`` and ``wc = W @ c``.  The
        increment is taken in the surrogate's dtype."""
        c = self.compress(gen, _sub(y, q))
        return c, apply_mixer(self.mixer, c, t)

    # -- fused state updates ------------------------------------------------

    def track(self, gen, v, q, m, g, g_prev, gamma: float, t=None):
        """PORTER Algorithm 1 lines 11-12: q += c; m += Wc;
        v' = v + gamma*(m - q) + g - g_prev.  Returns (v', q', m')."""
        c, wc = self.exchange(gen, v, q, t)
        return self.track_update(c, wc, v, q, m, g, g_prev, gamma)

    def track_update(self, c, wc, v, q, m, g, g_prev, gamma: float):
        """The second half of :meth:`track` (no communication)."""
        if self._use_kernel(q):
            qo, mo, vo = FL.plane_apply(
                lambda *p: ops.ef_track(*p, gamma),
                (q, m, v, c, wc, g, g_prev), 3)
            return vo, qo, mo
        q2 = tree_map(torch.add, q, c)
        m2 = tree_map(torch.add, m, wc)
        v2 = tree_map(lambda v0, mm, qq, gn, gp: v0 + gamma * (mm - qq)
                      + gn - gp, v, m2, q2, g, g_prev)
        return v2, q2, m2

    def step(self, gen, x, q, m, v, gamma: float, eta: float, t=None):
        """PORTER Algorithm 1 lines 13-14: q += c; m += Wc;
        x' = x + gamma*(m - q) - eta*v.  Returns (x', q', m')."""
        c, wc = self.exchange(gen, x, q, t)
        return self.step_update(c, wc, x, q, m, v, gamma, eta)

    def step_update(self, c, wc, x, q, m, v, gamma: float, eta: float):
        """The second half of :meth:`step` (no communication)."""
        if self._use_kernel(q):
            qo, mo, xo = FL.plane_apply(
                lambda *p: ops.ef_step(*p, gamma, eta),
                (q, m, x, c, wc, v), 3)
            return xo, qo, mo
        q2 = tree_map(torch.add, q, c)
        m2 = tree_map(torch.add, m, wc)
        x2 = tree_map(lambda x0, mm, qq, vv:
                      (x0 + gamma * (mm - qq) - eta * vv).to(x0.dtype),
                      x, m2, q2, v)
        return x2, q2, m2

    # -- wire accounting ----------------------------------------------------

    def wire_bytes(self, tree_or_d, n_agents: Optional[int] = None) -> float:
        """Model-level bytes crossing agent links per round for one buffer.

        Accepts an agent-stacked tree (n and d inferred) or a per-agent
        parameter count ``d`` plus ``n_agents``.  Dense gossip charges the
        compressor's own payload (``Compressor.wire_bits``).
        """
        if n_agents is None:
            leaves = tree_leaves(tree_or_d)
            n_agents = leaves[0].shape[0]
            d = sum(leaf.numel() // n_agents for leaf in leaves)
        else:
            d = int(tree_or_d)
        mode = getattr(self.mixer, "wire_mode", "dense")
        if mode != "dense":
            raise ValueError(f"wire accounting for gossip mode {mode!r} is "
                             "not ported yet (ROADMAP queue 1 item 12)")
        return n_agents * self.compressor.wire_bits(d) / 8.0
