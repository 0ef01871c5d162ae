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

Gossip: the dense, ring or plain packed executor, or (``wire=
"packed_bits"``) the ring or packed codec executor, to which
:meth:`CommRound.exchange` hands the whole compress-and-mix step: the codec
packs the increment, ``c`` is its unpacked round trip and ``wc = W @ c``.
Its qsgd noise is drawn from the round's generator after the SR words,
where a compressor's draws would be, so the two backends stay bitwise
comparable.

Time-varying topologies: every round method takes the absolute round index
``t`` (the state's step) and hands it to the mixer, which picks ``W_t``
from its schedule table; the fused updates read ``wc = W_t @ c`` as data.

Agents as processes: with a mixer built over an agent group
(``make_mixer(..., group=)``, or a fleet's ``make_fleet_mixer(...,
group=)``), every buffer is the rank's block of agent rows: one agent
(``(1, ...)``), or a fleet's k = n / ranks (``(k, ...)``).  A server
algorithm's engine has no mixer and takes its clients' group itself
(``clients``, one client a rank).  The engine's draws (the SR words, a
random compressor's) draw the one-card shape from the round's generator
and keep the rank's rows (:func:`repro_torch.core.agents.local_rows`),
and its wire accounting counts all ``group.n_agents * k`` agents, so both
are the one-card run's.

The model axis (``sharded``, a :class:`repro_torch.kernels.flatten.
ShardedFlatSpec`): every buffer is the rank's block, its agent row of its
shard of every leaf, and the engine runs on per-shard planes.  The SR
words are drawn at the one-card plane's shape and the rank keeps its
block (:meth:`ShardedFlatSpec.block`), so the per-shard ef updates are the
one-card ones element for element.  Without a ``compress_fn`` the
compressor sees each whole leaf, as XLA's all-gather gives the reference:
the leaves are all-gathered over ``'model'`` (one collective), compressed
and sliced back; ``launch.steps``' shard-local ``compress_fn`` compresses
each shard instead.  The wire accounting counts the whole replica, and
the packed windows per (leaf x model shard), a replicated leaf once
(``src/repro/core/comm_round.py:568-605``).

Push-sum (directed, column-stochastic ``W_t``): :meth:`CommRound.exchange_ps`
and :meth:`CommRound.step_ps` run the x-side round while carrying the
``(n,)`` push-sum weight planes (``xw``, ``q_w``, ``m_w``) through the same
exchange: the dense executor mixes the weight with the same ``W_t``, the
codec executor ships it bit-cast in its buffers.  The weight increment is
never compressed and the weight planes stay f32 under bf16 planes: the
column mass ``1^T xw = n`` must hold exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..kernels import flatten as FL
from ..kernels import ops, ref
from .agents import local_rows, model_shard
from ..tree import tree_flatten, tree_leaves, tree_map
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


def compress_stacked(comp: Compressor, gen: Optional[torch.Generator], tree,
                     group=None):
    """Compress each agent's row of every leaf independently (every agent
    compresses its own increment, per leaf).  Leaves draw from ``gen`` in
    tree order; under an agent ``group`` a random compressor draws the
    one-card shape and keeps this rank's rows."""
    kw = {} if group is None or comp.deterministic else {"group": group}
    return tree_map(
        lambda leaf: comp(gen, leaf.reshape(leaf.shape[0], -1), **kw)
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


def _ef_step_planes(planes, gamma: float, eta: float, sr_bits: SrBits):
    """``ops.ef_step`` over the planes of (q, m, x, c, wc, v).  The kernel
    takes its EF operands in one dtype; an f32 direction ``v`` beside bf16
    EF planes (porter-adam's preconditioned update, whose moments stay
    f32) sends the EF operands in as f32 and rounds the bf16-bound outputs
    with the same words through ``ops.sr_cast``: the epilogue's rounding,
    on the same f32 values."""
    q, m, x, c, wc, v = planes
    if v.dtype == q.dtype:
        return ops.ef_step(*planes, gamma, eta, sr_bits=sr_bits)
    ef = [t.to(_F32) for t in (q, m, c, wc)]
    outs = ops.ef_step(ef[0], ef[1], x, ef[2], ef[3], v, gamma, eta,
                       out_dtype=_F32)
    words = (None,) * 3 if sr_bits is None else sr_bits
    return tuple(o if w is None else ops.sr_cast(o, w)
                 for o, w in zip(outs, words))


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
    sharded: the per-shard layout on a grid with a model axis, or None.
    clients: a server algorithm's agent group (no mixer; one client a
      rank), or None.
    """

    compressor: Compressor
    mixer: MixFn
    compress_fn: Optional[Callable] = None
    backend: str = "auto"
    overlap: bool = False
    plane_dtype: Any = None
    sharded: Optional[FL.ShardedFlatSpec] = None
    clients: Any = None

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

    @property
    def group(self):
        """The agent group, the mixer's or a server's ``clients``, or None:
        every agent on one card."""
        group = getattr(self.mixer, "group", None)
        return self.clients if group is None else group

    def _agents(self, leaves) -> Tuple[int, int]:
        """``(n_agents, rows)`` of agent-stacked ``leaves``: all agents, and
        the rows held here (every one on one card, this rank's block of
        ``rows`` under a group of ``group.n_agents`` ranks)."""
        rows = leaves[0].shape[0]
        group = self.group
        return (rows if group is None else group.n_agents * rows), rows

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

        def words(shape, device):
            return torch.randint(0, 1 << 16, shape, generator=gen,
                                 dtype=torch.int32, device=device)

        def draw(t):
            device = tree_leaves(t)[0].device
            local = FL.flat_spec(t)
            if self.sharded is not None:
                full = words(self.sharded.global_layout(local).plane_shape,
                             device)
                return self.sharded.block(full, local)
            return local_rows(self.group, local.plane_shape,
                              lambda shape: words(shape, device))
        return tuple(draw(t) if need else None
                     for t, need in zip(trees, needs))

    # -- the shared front half: compress + mix ------------------------------

    def compress(self, gen, delta):
        """c = C(delta), per agent row of every leaf (under ``sharded``
        without a ``compress_fn``: of every whole leaf)."""
        if self.compress_fn is not None:
            return self.compress_fn(gen, delta)
        if self.sharded is not None:
            return self._compress_whole(gen, delta)
        return compress_stacked(self.compressor, gen, delta, self.group)

    def _compress_whole(self, gen, delta):
        """The compressor over each whole leaf of a model-sharded tree: the
        sharded leaves all-gathered over ``'model'`` in one collective,
        every leaf compressed as on one card, this rank's shard kept."""
        group, dims = self.sharded.group, self.sharded.dims()
        leaves, treedef = tree_flatten(delta)
        idx = [i for i, d in enumerate(dims) if d is not None]
        full = list(leaves)
        for i, g in zip(idx, group.all_gather([leaves[i] for i in idx],
                                              axis="model")):
            full[i] = torch.cat(list(g.unbind(0)), dim=dims[i])
        comp = compress_stacked(self.compressor, gen,
                                treedef.unflatten(full), self.group)
        return treedef.unflatten([
            model_shard(c, d, group.model_index, group.model_size).contiguous()
            for c, d in zip(tree_leaves(comp), dims)])

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

    def exchange_ps(self, gen, y, q, yw, qw, t=None):
        """:meth:`exchange` plus the (n,) push-sum weight plane ``yw``
        against its surrogate ``qw``.  Returns ``(c, wc, cw, wcw)``: the
        param round as :meth:`exchange`, ``cw = yw - qw`` (the weight
        increment, never compressed) and ``wcw = W_t @ cw``."""
        delta = _sub(y, q)
        dw = yw - qw
        if self._codec is not None:
            return self.mixer.exchange_ps(gen, delta, dw, t)
        push = getattr(self.mixer, "push", None)
        if push is None:
            raise ValueError(
                "push-sum needs a mixer with weight-plane transport (the "
                "dense or ring executor, or a codec executor built with "
                "wire='packed_bits'); the plain packed all-gather mixer "
                "ships (value, index) pairs only and has no slot for the "
                "weight scalar -- use gossip='ring'/'dense' or a bit-packed "
                "wire format for directed (column-stochastic) topologies")
        c = self.compress(gen, delta)
        wc, wcw = push(c, dw, t)
        return c, wc, dw, wcw

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
                lambda *p: _ef_step_planes(p, gamma, eta, sr_bits),
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

    def step_ps(self, gen, x, q, m, v, xw, qw, mw, gamma: float,
                eta: float, t=None):
        """Push-sum parameter step: :meth:`step` plus the weight recursion
        ``qw += cw; mw += W_t cw; xw' = xw + gamma (mw - qw)``, which
        composes to ``xw' = ((1 - gamma) I + gamma W_t) xw``.  Returns
        (x', q', m', xw', qw', mw')."""
        bits = self.sr_draw(gen, (q, m, x))
        c, wc, cw, wcw = self.exchange_ps(gen, x, q, xw, qw, t)
        return self.step_ps_update(c, wc, cw, wcw, x, q, m, v, xw, qw, mw,
                                   gamma, eta, sr_bits=bits)

    def step_ps_update(self, c, wc, cw, wcw, x, q, m, v, xw, qw, mw,
                       gamma: float, eta: float, sr_bits: SrBits = None):
        """The second half of :meth:`step_ps` (no communication): the
        params as :meth:`step_update` (the ``ef_step`` kernel on the
        kernel backend), the weight planes as three (n,) f32 AXPYs on
        every backend, never rounded."""
        x2, q2, m2 = self.step_update(c, wc, x, q, m, v, gamma, eta,
                                      sr_bits=sr_bits)
        qw2 = qw + cw
        mw2 = mw + wcw
        xw2 = (xw + gamma * (mw2 - qw2)).to(xw.dtype)
        return x2, q2, m2, xw2, qw2, mw2

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

    def _ps_weight_bytes(self, n_agents: int, measured: bool) -> float:
        """Bytes the push-sum weight adds to a round: one exact f32 weight
        an agent, 4 bytes (for a codec, measured: the words the codec's
        last buffer takes, :func:`wire_formats.measured_weight_nbytes`),
        times the agents whose buffers the mode ships ('ring': the live
        neighbours; every other mode: all n)."""
        per = (float(WF.measured_weight_nbytes(self._codec))
               if self._codec is not None and measured else 4.0)
        mode = getattr(self.mixer, "wire_mode", "dense")
        if mode == "ring":
            return (1.0 if n_agents == 2 else 2.0) * per
        return float(n_agents) * per

    def wire_bytes(self, tree_or_d, n_agents: Optional[int] = None,
                   push_sum: bool = False) -> float:
        """Model-level bytes crossing agent links per round for one buffer.

        Accepts an agent-stacked tree (n and d inferred) or a per-agent
        parameter count ``d`` plus ``n_agents``.  Dense gossip charges the
        compressor's own payload (``Compressor.wire_bits``), which does not
        narrow with the planes; the ring and packed byte models ship values
        at the ``plane_dtype`` width (2 B for bf16).  A codec executor
        charges the buffers its codec actually packs (:meth:`_codec_bytes`,
        measured); :meth:`wire_bytes_model` is the layout arithmetic it is
        checked against.  ``push_sum=True`` accounts an :meth:`exchange_ps`
        round: the weight's bytes (:meth:`_ps_weight_bytes`) on top.
        """
        if self._codec is not None:
            return self._codec_bytes(tree_or_d, n_agents, measured=True,
                                     push_sum=push_sum)
        tree = None
        if n_agents is None:
            tree = tree_or_d
            leaves = tree_leaves(tree)
            n_agents, rows = self._agents(leaves)
            d = sum(leaf.numel() // rows * m
                    for leaf, m in zip(leaves, self._shards(leaves)))
        else:
            d = int(tree_or_d)
        db = (4 if self.plane_dtype is None
              else torch.empty((), dtype=self.plane_dtype).element_size())
        extra = (self._ps_weight_bytes(n_agents, measured=True)
                 if push_sum else 0.0)
        mode = getattr(self.mixer, "wire_mode", "dense")
        if mode == "dense":
            return n_agents * self.compressor.wire_bits(d) / 8.0 + extra
        frac = getattr(self.mixer, "wire_frac", None)
        frac = self.compressor.rho if frac is None else frac
        if mode == "packed" and tree is not None:
            k_b = max(int(round(frac * WF.PACK_BLOCK)), 1)
            windows = self._packed_windows(tree)
            return float(n_agents) * windows * k_b * (db + 4.0) + extra
        return gossip_wire_bytes(mode, n_agents, d, frac=frac,
                                 dtype_bytes=db) + extra

    def wire_bytes_model(self, tree_or_d, n_agents: Optional[int] = None,
                         push_sum: bool = False) -> float:
        """The analytic byte model of the same round: for a codec executor
        the layout constants of its :class:`WireFormat` (windows times
        payload plus overhead bytes, 4 for a push-sum weight), for every
        other mixer the accounting of :meth:`wire_bytes` itself."""
        if self._codec is not None:
            return self._codec_bytes(tree_or_d, n_agents, measured=False,
                                     push_sum=push_sum)
        return self.wire_bytes(tree_or_d, n_agents, push_sum=push_sum)

    def _shards(self, leaves):
        """Each leaf's model shards: M for a sharded leaf under
        ``sharded``, else 1."""
        if self.sharded is None:
            return [1] * len(leaves)
        return self.sharded.shards()

    def _packed_windows(self, tree) -> int:
        """PACK_BLOCK windows the packed executors pad for one agent's row
        of ``tree``: each leaf pads separately, and under ``sharded`` each
        model shard of a leaf (a replicated leaf once), so windows are
        summed per (leaf x model shard), as the reference counts them
        (``src/repro/core/comm_round.py:568-605``)."""
        leaves = tree_leaves(tree)
        return sum(m * -(-(leaf.numel() // leaf.shape[0]) // WF.PACK_BLOCK)
                   for leaf, m in zip(leaves, self._shards(leaves)))

    def _codec_bytes(self, tree_or_d, n_agents: Optional[int],
                     measured: bool, push_sum: bool = False) -> float:
        """Link bytes of one buffer's round under the codec executor.

        Windows are counted per leaf (:meth:`_packed_windows`); the bytes of
        a window come from the buffers the codec packs
        (:func:`wire_formats.measured_pack_nbytes`) or from its layout
        constants (the model).  'ring' ships each agent's buffers to its
        live neighbours (one shift at n = 2, else two); 'packed' all-gathers
        every agent's buffers.  Both carry the push-sum weight words when
        ``push_sum``.
        """
        codec = self._codec
        if n_agents is None:
            n_agents = self._agents(tree_leaves(tree_or_d))[0]
            windows = self._packed_windows(tree_or_d)
        else:
            windows = codec.windows(int(tree_or_d))
        if measured:
            per_window = float(WF.measured_pack_nbytes(codec, WF.PACK_BLOCK))
        else:
            per_window = float(codec.payload_bytes_per_window
                               + codec.overhead_bytes_per_window)
        per_agent = windows * per_window
        if push_sum:
            per_agent += (float(WF.measured_weight_nbytes(codec))
                          if measured else 4.0)
        if getattr(self.mixer, "wire_mode", "packed") == "ring":
            return (1.0 if n_agents == 2 else 2.0) * per_agent
        return float(n_agents) * per_agent
