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
numerical oracle; it launches no kernel) and ``'auto'`` (``'kernel'`` for
CUDA tensors, ``'ref'`` for CPU ones, decided per call from the state's
device).

Mixed precision (``plane_dtype=bf16``): the EF buffers (q, m, v, g_prev)
are bf16 while the master params ``x`` stay f32.  Every update accumulates
in f32 and writes each bf16-bound result through the stochastic-rounding
cast ``high16(bits(x) + (r & 0xFFFF))``, so the EF drift stays unbiased:
on the kernel path the fused ef kernel rounds in its epilogue
(``ops.ef_*(sr_bits=)``), on the ref path ``_writeback`` rounds each leaf.
The random words ``r`` are an operand: :meth:`CommRound.sr_draw` draws them
from the round's generator, once per bf16-bound output, as one int32 plane
in that output's flat layout, *before* the round's compressor draws (so the
overlap order draws as the sequential one does).  Both backends read the
same plane -- the kernel path whole, the ref path unpacked per leaf -- so
they stay bitwise equal under bf16 too.  All-f32 buffers draw nothing, so
f32 runs keep their generator streams.  The parity tests inject the
reference's bits through ``sr_bits=``.

Gossip: the dense executor, or (``wire="packed_bits"``) the packed codec
executor, to which :meth:`CommRound.exchange` hands the whole compress-and-
mix step: the codec packs the increment, ``c`` is its unpacked round trip
and ``wc = W @ c``.  Its qsgd noise is drawn from the round's generator
after the SR words, where a compressor's draws would be, so the two
backends stay bitwise comparable.  Push-sum waits (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..kernels import flatten as FL
from ..kernels import ops, ref
from ..tree import tree_leaves, tree_map
from .compression import Compressor
from . import wire_formats as WF
from .gossip import MixFn, apply_mixer, gossip_wire_bytes

__all__ = ["CommRound", "compress_stacked", "resolve_backend",
           "resolve_engine"]

_BACKENDS = ("kernel", "ref", "auto")
_F32, _BF16 = torch.float32, torch.bfloat16

# per bf16-bound output, in kernel order (q, m, y): an int32 plane or None
SrBits = Optional[Sequence[Optional[torch.Tensor]]]


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


def _bf16(tree) -> bool:
    """True when ``tree``'s buffers take the stochastic-rounding writeback
    (their promoted dtype is bf16, the only sub-f32 plane dtype)."""
    return FL.derived_plane_dtype(tree) == _BF16


def _f32(tree):
    return tree_map(lambda leaf: leaf.to(_F32), tree)


def _writeback(tree_f32, like, bits):
    """Cast an f32 result tree to ``like``'s leaf dtypes (ref backend):
    stochastic rounding into bf16 leaves with the words of ``bits`` (an
    int32 plane in ``like``'s flat layout), a plain cast otherwise."""
    if bits is None:
        return tree_map(lambda v, l: v.to(l.dtype), tree_f32, like)
    spec = FL.flat_spec(like)
    words = FL.from_planes(bits, spec._replace(
        dtypes=(torch.int32,) * len(spec.dtypes), plane_dtype=torch.int32))
    return tree_map(lambda v, l, w: ref.sr_cast_ref(v, w)
                    if l.dtype == _BF16 else v.to(l.dtype),
                    tree_f32, like, words)


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One compressed communication round: compress -> accumulate -> update.

    compressor: the rho-compressor; also drives wire accounting.
    mixer: the dense executor ``tree -> W @ tree`` over the agent axis, or
      a codec executor (``mixer.wire_codec`` set) driven through
      ``mixer.exchange``.
    compress_fn: optional ``(gen, delta_tree) -> tree`` replacing the
      compressor's per-row call (not with a codec executor).
    backend: 'kernel' | 'ref' | 'auto'.
    overlap: issue both PORTER exchanges before either fused update; every
      value equals the sequential order's (bit-exact by construction).
    plane_dtype: declared storage dtype of the EF planes, None (f32), f32
      or bf16.  The actual plane dtype is derived per buffer tree, so f32
      params keep f32 planes beside bf16 EF buffers; this field drives the
      wire-byte width of the ring and packed byte models.
    """

    compressor: Compressor
    mixer: MixFn
    compress_fn: Optional[Callable] = None
    backend: str = "auto"
    overlap: bool = False
    plane_dtype: Any = None

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown comm-round backend {self.backend!r}; "
                             f"have {_BACKENDS}")
        if self.plane_dtype not in (None, _F32, _BF16):
            raise ValueError(
                f"plane_dtype must be f32 or bf16, got {self.plane_dtype}: "
                "the stochastic-rounding writeback targets bf16 only")
        if self.compress_fn is not None and self._codec is not None:
            raise ValueError(
                "wire='packed_bits' fuses (shard-local) compression with "
                "packing inside the codec executor; a compress_fn override "
                "would be silently ignored -- drop it")

    @property
    def _codec(self):
        return getattr(self.mixer, "wire_codec", None)

    def _use_kernel(self, tree) -> bool:
        device = tree_leaves(tree)[0].device
        return resolve_backend(self.backend, device) == "kernel"

    # -- stochastic-rounding plumbing ---------------------------------------

    def sr_draw(self, gen, trees) -> SrBits:
        """The random words of the SR writeback into ``trees`` (the three
        outputs, in kernel order q, m, y).

        Returns None, drawing nothing, when no tree is bf16; else one entry
        per tree: an int32 plane of ``flat_spec(tree).plane_shape`` drawn
        from ``gen`` (16 random bits per word), or None for an f32 tree.
        Overlap-mode steps call this before :meth:`exchange`, as the
        sequential methods do, so both orders draw alike.
        """
        needs = [_bf16(t) for t in trees]
        if not any(needs):
            return None
        return tuple(
            torch.randint(0, 1 << 16, FL.flat_spec(t).plane_shape,
                          generator=gen, dtype=torch.int32,
                          device=tree_leaves(t)[0].device) if need else None
            for t, need in zip(trees, needs))

    # -- the shared front half: compress + mix ------------------------------

    def compress(self, gen, delta):
        """c = C(delta), per agent row of every leaf."""
        if self.compress_fn is not None:
            return self.compress_fn(gen, delta)
        return compress_stacked(self.compressor, gen, delta)

    def exchange(self, gen, y, q, t=None) -> Tuple[Any, Any]:
        """Returns ``(c, wc)``: ``c = C(y - q)`` and ``wc = W @ c``.  The
        increment is taken in the surrogate's dtype (a deterministic cast:
        the next round's ``y - q`` measures its error afresh).  A codec
        executor compresses and mixes in one step: ``c`` is the increment's
        pack / unpack round trip."""
        delta = _sub(y, q)
        if self._codec is not None:
            return self.mixer.exchange(gen, delta, t)
        c = self.compress(gen, delta)
        return c, apply_mixer(self.mixer, c, t)

    # -- fused state updates ------------------------------------------------

    def track(self, gen, v, q, m, g, g_prev, gamma: float, t=None):
        """PORTER Algorithm 1 lines 11-12: q += c; m += Wc;
        v' = v + gamma*(m - q) + g - g_prev.  Returns (v', q', m')."""
        bits = self.sr_draw(gen, (q, m, v))
        c, wc = self.exchange(gen, v, q, t)
        return self.track_update(c, wc, v, q, m, g, g_prev, gamma,
                                 sr_bits=bits)

    def track_update(self, c, wc, v, q, m, g, g_prev, gamma: float,
                     sr_bits: SrBits = None):
        """The second half of :meth:`track` (no communication).
        ``sr_bits``: from :meth:`sr_draw` or injected; None casts
        deterministically."""
        if self._use_kernel(q):
            qo, mo, vo = FL.plane_apply(
                lambda *p: ops.ef_track(*p, gamma, sr_bits=sr_bits),
                (q, m, v, c, wc, g, g_prev), 3)
            return vo, qo, mo
        if sr_bits is not None:
            q2 = tree_map(torch.add, _f32(q), _f32(c))
            m2 = tree_map(torch.add, _f32(m), _f32(wc))
            v2 = tree_map(lambda v0, mm, qq, gn, gp: v0 + gamma * (mm - qq)
                          + gn - gp, _f32(v), m2, q2, _f32(g), _f32(g_prev))
            return (_writeback(v2, v, sr_bits[2]),
                    _writeback(q2, q, sr_bits[0]),
                    _writeback(m2, m, sr_bits[1]))
        q2 = tree_map(torch.add, q, c)
        m2 = tree_map(torch.add, m, wc)
        v2 = tree_map(lambda v0, mm, qq, gn, gp: v0 + gamma * (mm - qq)
                      + gn - gp, v, m2, q2, g, g_prev)
        return v2, q2, m2

    def step(self, gen, x, q, m, v, gamma: float, eta: float, t=None):
        """PORTER Algorithm 1 lines 13-14: q += c; m += Wc;
        x' = x + gamma*(m - q) - eta*v.  Returns (x', q', m')."""
        bits = self.sr_draw(gen, (q, m, x))
        c, wc = self.exchange(gen, x, q, t)
        return self.step_update(c, wc, x, q, m, v, gamma, eta, sr_bits=bits)

    def step_update(self, c, wc, x, q, m, v, gamma: float, eta: float,
                    sr_bits: SrBits = None):
        """The second half of :meth:`step` (no communication).  The f32
        master params take an exact writeback; only the q / m surrogates
        round stochastically."""
        if self._use_kernel(q):
            qo, mo, xo = FL.plane_apply(
                lambda *p: ops.ef_step(*p, gamma, eta, sr_bits=sr_bits),
                (q, m, x, c, wc, v), 3)
            return xo, qo, mo
        if sr_bits is not None:
            q2 = tree_map(torch.add, _f32(q), _f32(c))
            m2 = tree_map(torch.add, _f32(m), _f32(wc))
            x2 = tree_map(lambda x0, mm, qq, vv: x0 + gamma * (mm - qq)
                          - eta * vv, _f32(x), m2, q2, _f32(v))
            return (_writeback(x2, x, sr_bits[2]),
                    _writeback(q2, q, sr_bits[0]),
                    _writeback(m2, m, sr_bits[1]))
        q2 = tree_map(torch.add, q, c)
        m2 = tree_map(torch.add, m, wc)
        x2 = tree_map(lambda x0, mm, qq, vv:
                      (x0 + gamma * (mm - qq) - eta * vv).to(x0.dtype),
                      x, m2, q2, v)
        return x2, q2, m2

    def gossip_apply(self, gen, y, q, m, gamma: float, scale: float = 1.0,
                     t=None, sr_bits: SrBits = None):
        """CHOCO-SGD / SoteriaFL-style round (no tracking term):
        q += scale*c; m += scale*Wc; y' = y + gamma*(m - q).

        Returns (y', q', m').  ``scale`` is 1 for CHOCO and the shift
        stepsize for shifted compression.  ``sr_bits``: injected SR words;
        None draws them (:meth:`sr_draw`) before the exchange.
        """
        if sr_bits is None:
            sr_bits = self.sr_draw(gen, (q, m, y))
        c, wc = self.exchange(gen, y, q, t)
        if self._use_kernel(q):
            qo, mo, yo = FL.plane_apply(
                lambda *p: ops.ef_gossip(*p, gamma, scale, sr_bits=sr_bits),
                (q, m, y, c, wc), 3)
            return yo, qo, mo
        if sr_bits is not None:
            q2 = tree_map(lambda a, b: a + scale * b, _f32(q), _f32(c))
            m2 = tree_map(lambda a, b: a + scale * b, _f32(m), _f32(wc))
            y2 = tree_map(lambda y0, mm, qq: y0 + gamma * (mm - qq),
                          _f32(y), m2, q2)
            return (_writeback(y2, y, sr_bits[2]),
                    _writeback(q2, q, sr_bits[0]),
                    _writeback(m2, m, sr_bits[1]))
        q2 = tree_map(lambda a, b: a + scale * b, q, c)
        m2 = tree_map(lambda a, b: a + scale * b, m, wc)
        y2 = tree_map(lambda y0, mm, qq: y0 + gamma * (mm - qq), y, m2, q2)
        return y2, q2, m2

    def shift(self, gen, y, q, scale: float = 1.0):
        """SoteriaFL shifted compression (mirrorless surrogate accumulate):
        c = C(y - q); q' = q + scale*c.  Returns (c, q'); the caller
        aggregates ``c`` on its server (a mean, not a gossip mix)."""
        c = self.compress(gen, _sub(y, q))
        return c, tree_map(lambda a, b: (a + scale * b).to(a.dtype), q, c)

    # -- wire accounting ----------------------------------------------------

    def wire_bytes(self, tree_or_d, n_agents: Optional[int] = None) -> float:
        """Model-level bytes crossing agent links per round for one buffer.

        Accepts an agent-stacked tree (n and d inferred) or a per-agent
        parameter count ``d`` plus ``n_agents``.  Dense gossip charges the
        compressor's own payload (``Compressor.wire_bits``), which does not
        narrow with the planes; the ring and packed byte models ship values
        at the ``plane_dtype`` width (2 B for bf16).  A codec executor
        charges the buffers its codec actually packs (:meth:`_codec_bytes`,
        measured); :meth:`wire_bytes_model` is the layout arithmetic it is
        checked against.
        """
        if self._codec is not None:
            return self._codec_bytes(tree_or_d, n_agents, measured=True)
        tree = None
        if n_agents is None:
            tree = tree_or_d
            leaves = tree_leaves(tree)
            n_agents = leaves[0].shape[0]
            d = sum(leaf.numel() // n_agents for leaf in leaves)
        else:
            d = int(tree_or_d)
        db = (4 if self.plane_dtype is None
              else torch.empty((), dtype=self.plane_dtype).element_size())
        mode = getattr(self.mixer, "wire_mode", "dense")
        if mode == "dense":
            return n_agents * self.compressor.wire_bits(d) / 8.0
        if mode == "ring" or (mode == "packed" and tree is None):
            frac = getattr(self.mixer, "wire_frac", None)
            frac = self.compressor.rho if frac is None else frac
            return gossip_wire_bytes(mode, n_agents, d, frac=frac,
                                     dtype_bytes=db)
        raise ValueError(f"wire accounting for gossip mode {mode!r} over a "
                         "tree is not ported yet (ROADMAP queue 1 item 12)")

    def wire_bytes_model(self, tree_or_d,
                         n_agents: Optional[int] = None) -> float:
        """The analytic byte model of the same round: for a codec executor
        the layout constants of its :class:`WireFormat` (windows times
        payload plus overhead bytes), for every other mixer the accounting
        of :meth:`wire_bytes` itself."""
        if self._codec is not None:
            return self._codec_bytes(tree_or_d, n_agents, measured=False)
        return self.wire_bytes(tree_or_d, n_agents)

    @staticmethod
    def _packed_windows(tree, n_agents: int) -> int:
        """PACK_BLOCK windows the packed codec executor pads for ``tree``:
        each leaf pads separately, so windows are summed per leaf."""
        return sum(-(-(leaf.numel() // n_agents) // WF.PACK_BLOCK)
                   for leaf in tree_leaves(tree))

    def _codec_bytes(self, tree_or_d, n_agents: Optional[int],
                     measured: bool) -> float:
        """Link bytes of one buffer's round under the codec executor.

        Windows are counted per leaf (:meth:`_packed_windows`); the bytes of
        a window come from the buffers the codec packs
        (:func:`wire_formats.measured_pack_nbytes`) or from its layout
        constants (the model).  'packed' all-gathers every agent's buffers.
        """
        codec = self._codec
        if n_agents is None:
            n_agents = tree_leaves(tree_or_d)[0].shape[0]
            windows = self._packed_windows(tree_or_d, n_agents)
        else:
            windows = codec.windows(int(tree_or_d))
        if measured:
            per_window = float(WF.measured_pack_nbytes(codec, WF.PACK_BLOCK))
        else:
            per_window = float(codec.payload_bytes_per_window
                               + codec.overhead_bytes_per_window)
        return float(n_agents) * windows * per_window
