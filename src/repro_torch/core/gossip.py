"""Gossip (neighbor mixing) over agent-stacked trees: every agent on one
card, or one agent a process.

PORTER communicates increments: every agent sends ``c_i = C(y_i - q_i)``,
accumulates its surrogate ``q_i += c_i`` and its mixing mirror
``m_i += sum_j w_ij c_j``.  The executors of ``src/repro/core/gossip.py``:

* dense: ``W @ c`` over the leading agent axis, one f32 matrix product per
  leaf (``make_dense_mixer``);
* ring (W banded on a ring): every agent adds its own term and its two
  neighbours', ``w_self c_i + w_prev c_{i-1} + w_next c_{i+1}``
  (``make_ring_mixer``);
* plain packed: every agent keeps the top-k (value, int32 index) pairs of
  each PACK_BLOCK window of its increment, and every receiver scatter-adds
  all senders' weighted pairs (``make_packed_mixer``);
* codec (``wire="packed_bits"``): every agent packs its increment into the
  bit-packed buffers of a :class:`WireFormat` and the receiver unpacks its
  senders' buffers, over the packed all-gather
  (``make_packed_codec_mixer``) or the ring's two shifts
  (``make_ring_codec_mixer``).

The reference runs the ring, packed and codec executors as ``shard_map``
programs with one agent per device: ``ppermute`` shifts for the ring, an
all-gather for packed.  Each executor exists here in two forms.

*One card* (the five above): all agents sit in one tensor, a shift is a
roll along the agent axis (the "prev" copy rolled by +1, agent i - 1
arriving at i; "next" by -1), the all-gather is the identity, and a codec
packs every agent's windows once and unpacks them once.

*Across processes* (``make_mixer(..., group=)``, one agent a rank of a
:class:`repro_torch.launch.mesh.AgentGroup`; ``make_dense_process_mixer``
and its siblings): every tensor is the rank's ``(1, ...)`` block (the
dense one's also a fleet's ``(k, ...)``, :mod:`repro_torch.core.fleet`); the
ring shifts all leaves to each live neighbour in one point-to-point
exchange, the packed executors and the dense one all-gather, the codecs
pack the rank's windows once and unpack its own and the received buffers
in one call.  Each rank computes what the one-card executor computes for
its agent, in the same order, so its rows are bitwise the one-card
executor's (the dense and packed-codec products are the whole ``W_t @ c``
on the gathered rows, a matrix product's rounding depending on its row
count).  On the ``(pod, data)`` grid the ring sends straight to the
global neighbour, which is what the reference's seam patch computes.  On a
``(data, model)`` grid every executor runs on the rank's shards among the
ranks of its model index; a qsgd codec draws the global noise of every
(agent, model shard) pair's windows and packs with its block
(:func:`_pack_rank`), so the shards of one agent never share a draw.

Each executor's ``shipped_nbytes`` holds the bytes of its last call's
buffers, as the reference's wire accounting counts them (the ring's for
one agent, to its live neighbours; packed's and dense's for all agents),
and ``budget`` its :class:`GossipBudget`.

Time-varying topologies: every executor takes a static ``(n, n)`` matrix
or a stacked ``(period, n, n)`` schedule table.  A table's mixer is tagged
``time_varying`` and takes the absolute round index ``t`` (the state's
step, a host ``int``): ``W_t`` (the ring's three band weights) is row ``t
% period`` of an f32 copy of the table kept on each device it is used on,
so picking it costs no copy from the host and no sync.

Push-sum (directed, column-stochastic W): the dense and ring executors'
``mix.push(tree, wvec, t)`` also mixes the ``(n,)`` push-sum weight with
the same ``W_t`` (across processes in the same messages as the leaves);
the codec executors' ``mix.exchange_ps(gen, tree, dw, t)`` carries the
exact f32 weight increment as bit-cast words appended to its last wire
buffer (4 bytes an agent).  The weight is never compressed.  The plain
packed executor ships (value, index) pairs only and has no ``push``, as
in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..tree import tree_flatten, tree_map
from .mixing import Topology, TopologySchedule
from .wire_formats import PACK_BLOCK, WireFormat, to_windows, topk_keep

__all__ = ["MixFn", "GossipBudget", "PACK_BLOCK", "apply_mixer",
           "make_dense_mixer", "make_ring_mixer", "make_packed_mixer",
           "make_ring_codec_mixer", "make_packed_codec_mixer",
           "make_dense_process_mixer", "make_ring_process_mixer",
           "make_packed_process_mixer", "make_ring_codec_process_mixer",
           "make_packed_codec_process_mixer", "make_mixer",
           "reference_budget", "gossip_wire_bytes", "make_codec_compress"]

MixFn = Callable[..., object]


@dataclasses.dataclass(frozen=True)
class GossipBudget:
    """Declared collective budget of one gossip executor (the reference's
    ``repro.core.gossip.GossipBudget``).

    ``per_leaf`` maps a collective category (``collective-permute``,
    ``all-gather``) to the most such ops the executor may issue per
    gossiped leaf and exchange; a category absent from it is forbidden.
    ``spmd_dependent`` marks executors whose collectives a partitioner
    chooses.  Every executor of :func:`make_mixer` carries the reference's
    budget (``mix.budget``).  On one card they issue none; across
    processes the rank's :class:`~repro_torch.launch.mesh.AgentGroup`
    counts what they issue (``group.census``), and the tests hold the count
    to the budget.  On a grid with a model axis each executor runs on the
    rank's shards among the ranks of its model index, so the budget holds
    per shard and the model axis's collectives (the tensor-parallel
    forward's, the clip's) count apart (``group.model_census``).  The
    fleet mixer over processes (:func:`repro_torch.core.fleet.
    make_fleet_mixer` ``group=``) declares the dense process executor's
    one all-gather; the static census over every executor is ROADMAP
    queue 1 item 14.
    """

    executor: str
    per_leaf: "dict[str, int]" = dataclasses.field(default_factory=dict)
    spmd_dependent: bool = False
    note: str = ""


# wire buffers a codec's pack returns (top-k and qsgd alike: payload and
# indices or scales); the reference ships each through its own collective
WIRE_BUFFERS = 2


def reference_budget(executor: str, live: int = 0, axes: int = 1,
                     note: str = "") -> GossipBudget:
    """The reference's budget of ``executor`` (``src/repro/core/gossip.py``
    ``:211``, ``:431``, ``:547``, ``:852``, ``:1003``): the dense einsum's
    collectives are its partitioner's; a ring issues a shift a live band
    and agent axis (a codec's, each of its buffers); the packed
    executors an all-gather each for values and indices, or a codec's
    buffers."""
    if executor == "dense":
        return GossipBudget("dense", {}, spmd_dependent=True, note=note or
                            "einsum over the agent axis; unmeshed it emits "
                            "zero collectives")
    per_leaf = {
        "ring": lambda: {"collective-permute": live * axes},
        "ring_codec": lambda: {"collective-permute":
                               live * axes * WIRE_BUFFERS},
        "packed": lambda: {"all-gather": 2},
        "packed_codec": lambda: {"all-gather": WIRE_BUFFERS},
    }[executor]()
    return GossipBudget(executor, per_leaf, note=note)


def apply_mixer(mixer: MixFn, tree, t=None):
    """Invoke ``mixer``, forwarding the round index only when it needs one."""
    if getattr(mixer, "time_varying", False):
        if t is None:
            raise ValueError(
                "this mixer runs a time-varying topology schedule and needs "
                "the absolute round index (pass t=state.step)")
        return mixer(tree, t)
    return mixer(tree)


def _mix_leaf(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    n = leaf.shape[0]
    out = w @ leaf.reshape(n, -1).to(torch.float32)
    return out.reshape(leaf.shape).to(leaf.dtype)


def _table_on(w, what: str):
    """For a static (n, n) matrix or a (period, n, n) schedule table ``w``:
    a function ``(device, t) -> W_t``, the f32 (n, n) matrix of round ``t``
    on ``device``.  The f32 table is made on a device at its first use
    there and kept (building a mixer touches no device); a schedule's
    ``W_t`` is ``table[t % period]``, indexed with the host int ``t``."""
    w_np = np.asarray(w, dtype=np.float64)
    if w_np.ndim not in (2, 3):
        raise ValueError(f"mixing matrix must be (n, n) or (period, n, n); "
                         f"got shape {w_np.shape}")
    time_varying = w_np.ndim == 3
    on_device: Dict[torch.device, torch.Tensor] = {}

    def w_at(device: torch.device, t=None) -> torch.Tensor:
        table = on_device.get(device)
        if table is None:
            table = on_device[device] = torch.as_tensor(
                w_np, dtype=torch.float32).to(device)
        if not time_varying:
            return table
        if t is None:
            raise ValueError(f"the time-varying {what} needs the round "
                             "index (pass t=state.step)")
        return table[t % table.shape[0]]

    w_at.time_varying = time_varying
    return w_at


def make_dense_mixer(w) -> MixFn:
    """``tree -> W_t @ tree`` over the agent axis, in f32.

    ``w``: a static (n, n) matrix, or a (period, n, n) schedule table,
    whose mixer takes the round index ``t``.  ``mix.push(tree, wvec, t)``
    returns ``(W_t @ tree, W_t @ wvec)`` for the (n,) push-sum weight: the
    reference concatenates the weight as one more column of the first
    leaf's product; here it takes its own (n, n) @ (n,) product, so the
    params are bitwise the plain call's on every device.
    """
    w_at = _table_on(w, "dense mixer")

    def mix(tree, t=None):
        return tree_map(lambda leaf: _mix_leaf(w_at(leaf.device, t), leaf),
                        tree)

    def push(tree, wvec, t=None):
        w_t = w_at(wvec.device, t)
        return mix(tree, t), (w_t @ wvec.to(torch.float32)).to(wvec.dtype)

    mix.push = push
    mix.time_varying = w_at.time_varying
    mix.budget = reference_budget("dense")
    return mix


def _ring_weights(w: np.ndarray) -> Tuple[float, float, float]:
    """``(w_self, w_prev, w_next)`` of a circulant ring mixing matrix.

    At ``n == 2`` the two bands coincide (both shifts deliver the one
    neighbour), so the whole neighbour weight goes to ``w_prev`` and
    ``w_next`` is 0: one shift, no double count.  The structure check adds
    the bands up, so coinciding positions cannot mask a mismatch.
    """
    n = w.shape[0]
    if n < 2:
        raise ValueError("ring gossip needs at least 2 agents; "
                         "use dense gossip for a single agent")
    w_self = float(w[0, 0])
    w_next = float(w[0, 1 % n])
    w_prev = float(w[0, (n - 1) % n])
    if n == 2:
        w_prev, w_next = float(w[0, 1]), 0.0
    want = np.zeros_like(w)
    for i in range(n):
        want[i, i] += w_self
        want[i, (i + 1) % n] += w_next
        want[i, (i - 1) % n] += w_prev
    if not np.allclose(want, w, atol=1e-10):
        raise ValueError("mixing matrix is not a circulant ring band; "
                         "use dense or packed gossip")
    return w_self, w_prev, w_next


def _ring_bands(w, what: str):
    """The ring's bands for a static (n, n) matrix or a (period, n, n)
    table ``w``: ``(bands_at, use_prev, use_next)``.  ``bands_at(device,
    dtype, t)`` gives the three 0-d band weights of round ``t``: a static
    matrix's Python floats rounded to ``dtype`` (the reference multiplies
    each leaf by them as weakly typed scalars), a table's row ``t %
    period`` of its f32 ``(period, 3)`` copy on ``device`` (always f32: the
    reference traces them as f32 arrays).  A band that is 0 in every round
    ships nothing: ``use_prev`` / ``use_next`` are fixed over the whole
    window, as the reference's program is."""
    w_np = np.asarray(w, dtype=np.float64)
    if w_np.ndim not in (2, 3):
        raise ValueError(f"mixing matrix must be (n, n) or (period, n, n); "
                         f"got shape {w_np.shape}")
    time_varying = w_np.ndim == 3
    table = np.array([_ring_weights(wt) for wt in w_np] if time_varying
                     else [_ring_weights(w_np)])
    use_prev = bool(np.any(table[:, 1] != 0.0))
    use_next = bool(np.any(table[:, 2] != 0.0))
    cache: Dict[tuple, torch.Tensor] = {}

    def bands_at(device: torch.device, dtype: torch.dtype, t=None):
        dtype = torch.float32 if time_varying else dtype
        on = cache.get((device, dtype))
        if on is None:
            on = cache[(device, dtype)] = torch.as_tensor(
                table, dtype=dtype).to(device)
        if not time_varying:
            return on[0].unbind()
        if t is None:
            raise ValueError(f"the time-varying {what} needs the round "
                             "index (pass t=state.step)")
        return on[t % on.shape[0]].unbind()

    bands_at.time_varying = time_varying
    return bands_at, use_prev, use_next


def _ring_sum(x, bands, prev=None, nxt=None):
    """``b_self x + b_prev prev + b_next nxt``, accumulated in that order in
    ``bands``' dtype (every term converted to it), a dead band (None) left
    out.  ``prev`` is the copy of agent i - 1 arriving at i, ``nxt`` that of
    agent i + 1: a roll of the stacked agents on one card, a received
    neighbour across processes."""
    dt = bands[0].dtype
    out = bands[0] * (x if x.dtype == dt else x.to(dt))
    if prev is not None:
        out = out + bands[1] * (prev if prev.dtype == dt else prev.to(dt))
    if nxt is not None:
        out = out + bands[2] * (nxt if nxt.dtype == dt else nxt.to(dt))
    return out


def _rolled_sum(x, bands, use_prev: bool, use_next: bool):
    """:func:`_ring_sum` over the leading agent axis of one card: agent i -
    1 arrives at i by a roll of +1, agent i + 1 by a roll of -1."""
    return _ring_sum(x, bands, x.roll(1, 0) if use_prev else None,
                     x.roll(-1, 0) if use_next else None)


def make_ring_mixer(w) -> MixFn:
    """Banded-W gossip: ``w_self c_i + w_prev c_{i-1} + w_next c_{i+1}``
    for every agent i at once, the neighbour copies rolls of the leaf along
    the agent axis (the reference's two ``ppermute`` shifts).

    ``w``: a static circulant (n, n) ring matrix, whose band weights
    multiply each leaf in its own dtype (bf16 products and sums for bf16
    leaves, as the reference's weakly typed scalars), or a (period, n, n)
    table whose every round is a ring band, whose bands are f32 and picked
    by the round ``t`` (bf16 leaves mixed in f32, then cast).

    ``mix.push(tree, wvec, t)`` mixes the (n,) push-sum weight with the
    same bands, exactly in f32; every leaf is then mixed with f32 bands, as
    the reference's push takes them from an f32 array.
    ``mix.shipped_nbytes``: the bytes one agent shipped in the last call,
    its leaves in their dtypes (and, for a push, its f32 weight) to each
    live neighbour.
    """
    bands_at, use_prev, use_next = _ring_bands(w, "ring mixer")
    live = int(use_prev) + int(use_next)

    def _mix(tree, t, f32: bool):
        def leaf_mix(leaf):
            bands = bands_at(leaf.device, torch.float32 if f32 else
                             leaf.dtype, t)
            return _rolled_sum(leaf, bands, use_prev, use_next).to(leaf.dtype)
        out = tree_map(leaf_mix, tree)
        leaves = tree_flatten(tree)[0]
        mix.shipped_nbytes = live * sum(
            leaf[0].numel() * leaf.element_size() for leaf in leaves)
        return out

    def mix(tree, t=None):
        return _mix(tree, t, False)

    def push(tree, wvec, t=None):
        bands = bands_at(wvec.device, torch.float32, t)
        w_m = _rolled_sum(wvec, bands, use_prev, use_next).to(wvec.dtype)
        out = _mix(tree, t, True)
        mix.shipped_nbytes += live * 4          # the exact f32 weight
        return out, w_m

    mix.push = push
    mix.time_varying = bands_at.time_varying
    mix.shipped_nbytes = 0
    mix.budget = reference_budget("ring", live)
    return mix


def _topk_pairs(leaf, k_b: int):
    """Every agent row's top-k (value, int32 index) pairs of each
    PACK_BLOCK window: ``(rows, nb, k_b)`` each, ties to the lower index
    (a stable descending sort)."""
    rows = to_windows(leaf.reshape(leaf.shape[0], -1))     # (r, nb, block)
    idx = torch.sort(rows.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k_b]
    return torch.gather(rows, -1, idx), idx.to(torch.int32)


def _scatter_pairs(leaf, vals, idx, w_rows):
    """The receivers' windows: for every receiver row r of ``w_rows`` (r,
    n), the f32 scatter-add of every sender j's pairs ``(vals[j],
    idx[j])`` times ``w_rows[r, j]``, senders in order onto +0.0, cut to
    the leaf's length and cast to its dtype (``leaf``: the receivers'
    rows)."""
    r, nb, k_b = w_rows.shape[0], vals.shape[1], vals.shape[2]
    weighted = vals.to(torch.float32)
    out = torch.zeros((r, nb, PACK_BLOCK), dtype=torch.float32,
                      device=vals.device)
    for j in range(vals.shape[0]):
        out.scatter_add_(-1, idx[j].long().expand_as(out[..., :k_b]),
                         w_rows[:, j, None, None] * weighted[j])
    out = out.reshape(r, -1)[:, :leaf[0].numel()]
    return out.reshape(leaf.shape).to(leaf.dtype)


def make_packed_mixer(w, frac: float) -> MixFn:
    """W @ c where only top-k (value, int32 index) pairs cross the wire.

    Each agent's leaf is padded to PACK_BLOCK windows and keeps the k_b =
    max(round(frac * PACK_BLOCK), 1) largest magnitudes of each window,
    ties to the lower index (a stable descending sort, ``jax.lax.top_k``'s
    order); values keep the leaf's dtype.  Receiver i's window is the f32
    scatter-add of every sender j's pairs times ``w_ij``, senders in order
    j = 0 .. n - 1 onto +0.0, then cast to the leaf's dtype: exact where
    the increment is k-sparse per window (top-k, block-top-k), a second
    compression otherwise, as in the reference.  ``w``: a static (n, n)
    matrix or a (period, n, n) table (then ``t`` is required).
    ``mix.shipped_nbytes``: the pairs of all agents in the last call, what
    the all-gather ships.
    """
    w_at = _table_on(w, "packed mixer")
    k_b = max(int(round(frac * PACK_BLOCK)), 1)

    def leaf_mix(leaf, w_t):
        vals, idx = _topk_pairs(leaf, k_b)
        shipped = vals.numel() * vals.element_size() + idx.numel() * 4
        return _scatter_pairs(leaf, vals, idx, w_t), shipped

    def mix(tree, t=None):
        leaves, treedef = tree_flatten(tree)
        w_t = w_at(leaves[0].device, t)
        outs = [leaf_mix(leaf, w_t) for leaf in leaves]
        mix.shipped_nbytes = sum(o[1] for o in outs)
        return treedef.unflatten([o[0] for o in outs])

    mix.time_varying = w_at.time_varying
    mix.shipped_nbytes = 0
    mix.budget = reference_budget("packed")
    return mix


def _codec_mix_error(*a, **k):
    raise ValueError(
        "codec gossip executors fuse compression with packing and return "
        "(c, wc); call mix.exchange(key, tree, t) -- the CommRound engine "
        "does this -- instead of mixing a pre-compressed tree")


def _append_weight(bufs, dw):
    """The exact f32 weight increments ``dw`` (n,) bit-cast into words of
    the last buffer's dtype and appended to its flattened payload: ->
    (the buffers to ship, the last buffer's shape)."""
    last = bufs[-1]
    if last.element_size() not in (2, 4):
        raise ValueError(f"cannot bit-cast an f32 push-sum weight into "
                         f"{last.dtype} wire words")
    words = dw.to(torch.float32).contiguous().view(last.dtype)
    return (tuple(bufs[:-1]) + (torch.cat([last.reshape(-1), words]),),
            last.shape)


def _split_weight(bufs, last_shape, n: int):
    """Inverse of :func:`_append_weight`: -> (the buffers, the f32 weight
    increments)."""
    last = bufs[-1]
    nw = n * 4 // last.element_size()
    body, words = last[:last.numel() - nw], last[last.numel() - nw:]
    return (tuple(bufs[:-1]) + (body.reshape(last_shape),),
            words.view(torch.float32))


def _codec_mixer(codec: WireFormat, mix_rows, time_varying: bool,
                 shipped, budget: GossipBudget) -> MixFn:
    """A codec executor, all agents on one card: ``mix.exchange(gen,
    delta, t=None, noise=None) -> (c, wc)`` and ``mix.exchange_ps(gen,
    delta, dw, t=None, noise=None) -> (c, wc, cw, wcw)``.

    Every leaf is flattened per agent and padded to its own PACK_BLOCK
    windows, as the reference's ``_pack_local`` pads each leaf; all
    leaves' windows stack into one ``(R, PACK_BLOCK)`` f32 row matrix (leaf
    by leaf in tree order, agent by agent within a leaf), which is packed
    once and unpacked once.  ``c`` is the unpacked increment in each leaf's
    dtype; ``wc`` is ``mix_rows(c_leaf, t)`` of each leaf's f32 ``(n, d)``
    unpacked rows, then cast, as the reference's receive side sums f32
    unpacked buffers.  A qsgd codec draws its U[0, 1) noise for all R rows
    from ``gen`` in one call; ``noise=`` injects it (the parity tests hand
    over the reference's uniforms).  With ``dw``, the (n,) f32 push-sum
    weight increments are bit-cast into the last buffer (4 bytes an agent,
    as the reference appends each agent's weight to its own last buffer);
    ``cw`` is what came off the wire, bitwise ``dw``, and ``wcw =
    mix_rows(cw, t)``.  ``mix.shipped_nbytes`` is ``shipped(nbytes, n)``
    of the buffers the last exchange packed."""

    def mix(*a, **k):
        _codec_mix_error()

    def _exchange(gen, tree, t, noise, dw):
        leaves, treedef = tree_flatten(tree)
        n = leaves[0].shape[0]
        windows = [to_windows(leaf.reshape(n, -1).to(torch.float32))
                   .reshape(-1, PACK_BLOCK) for leaf in leaves]
        rows = torch.cat(windows) if len(windows) > 1 else windows[0]
        if noise is None and not codec.deterministic:
            noise = torch.rand(rows.shape, generator=gen, device=rows.device)
        bufs = codec.pack(rows, noise)
        if dw is not None:
            bufs, last_shape = _append_weight(bufs, dw)
        mix.shipped_nbytes = shipped(
            sum(b.numel() * b.element_size() for b in bufs), n)
        if dw is not None:
            bufs, cw = _split_weight(bufs, last_shape, n)
        c_rows = codec.unpack(*bufs)
        cs, wcs, start = [], [], 0
        for leaf, win in zip(leaves, windows):
            c_leaf = c_rows[start:start + win.shape[0]].reshape(n, -1)
            c_leaf = c_leaf[:, :leaf[0].numel()]
            start += win.shape[0]
            cs.append(c_leaf.reshape(leaf.shape).to(leaf.dtype))
            wcs.append(mix_rows(c_leaf, t).reshape(leaf.shape)
                       .to(leaf.dtype))
        out = treedef.unflatten(cs), treedef.unflatten(wcs)
        if dw is None:
            return out
        return out + (cw.to(dw.dtype), mix_rows(cw, t).to(dw.dtype))

    def exchange(gen, tree, t=None, noise=None):
        return _exchange(gen, tree, t, noise, None)

    def exchange_ps(gen, tree, dw, t=None, noise=None):
        return _exchange(gen, tree, t, noise, dw)

    mix.exchange = exchange
    mix.exchange_ps = exchange_ps
    mix.time_varying = time_varying
    mix.wire_codec = codec
    mix.shipped_nbytes = 0
    mix.budget = budget
    return mix


def make_packed_codec_mixer(w, codec: WireFormat) -> MixFn:
    """Gossip over bit-packed buffers, all agents on one card: every agent
    unpacks every sender's buffers, ``wc = W_t @ c``, the f32 product of the
    unpacked rows (:func:`_codec_mixer` has the exchange).  ``w`` is a
    static (n, n) matrix or a (period, n, n) schedule table (then ``t`` is
    required).  ``mix.shipped_nbytes``: all agents' buffers, what the
    all-gather ships."""
    w_at = _table_on(w, "packed codec mixer")
    return _codec_mixer(codec, lambda c, t: w_at(c.device, t) @ c,
                        w_at.time_varying, lambda nbytes, n: nbytes,
                        reference_budget("packed_codec"))


def make_ring_codec_mixer(w, codec: WireFormat) -> MixFn:
    """Banded-W gossip over bit-packed buffers, all agents on one card
    (:func:`_codec_mixer` has the exchange: every agent's windows packed
    once and unpacked once).  The neighbour terms are the unpacked rows
    rolled by +1 (agent i - 1's buffers arriving at i) and -1 along the
    agent axis, which is what the reference's receiver unpacks from its
    shifted buffers, since every window unpacks on its own: ``wc = b_self
    c + b_prev roll(c, +1) + b_next roll(c, -1)``, in f32 in that order,
    and the push-sum weight the same; a band that is 0 over the whole
    window ships nothing.  ``w``: a static circulant ring matrix or a
    (period, n, n) table of ring bands.  ``mix.shipped_nbytes``: the bytes
    one agent shipped in the last exchange, its buffers to each live
    neighbour."""
    bands_at, use_prev, use_next = _ring_bands(w, "ring codec mixer")
    live = int(use_prev) + int(use_next)
    return _codec_mixer(
        codec, lambda c, t: _rolled_sum(c, bands_at(c.device, torch.float32,
                                                    t), use_prev, use_next),
        bands_at.time_varying, lambda nbytes, n: live * nbytes // n,
        reference_budget("ring_codec", live))


# ---------------------------------------------------------------------------
# Across processes: one agent a rank, each executor over an AgentGroup
# (repro_torch.launch.mesh), its tensors this rank's (1, ...) blocks (the
# dense one also a fleet's (k, ...) blocks, core/fleet.py)
# ---------------------------------------------------------------------------

def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_block(leaves, block: int = 1) -> None:
    bad = [tuple(leaf.shape) for leaf in leaves
           if leaf.dim() < 1 or leaf.shape[0] != block]
    if bad:
        raise ValueError("an executor across processes takes this rank's "
                         f"({block}, ...) block of every leaf; got shapes "
                         f"{bad}")


def gather_blocks(group, leaves):
    """Every rank's ``(k, ...)`` block of each of ``leaves``, joined
    rank-major into the one-card ``(n_ranks * k, ...)`` tensor, in one
    all-gather."""
    return [f.reshape((-1,) + tuple(leaf.shape[1:]))
            for f, leaf in zip(group.all_gather(leaves), leaves)]


def make_dense_process_mixer(w, group, block: int = 1) -> MixFn:
    """The dense executor with ``block`` agents a rank (one, or a fleet's
    k = n / ranks): every leaf is all-gathered (all of a call's leaves in
    one all-gather) and the rank keeps its rows of the whole ``W_t @ C``.
    The whole product, not the rows alone: a matrix product's rounding may
    depend on its row count, and a row of the whole product is bitwise the
    one-card executor's.  ``mix.push`` gathers the ``(block,)`` push-sum
    weights in the same message.  ``mix.shipped_nbytes``: every agent's
    leaves, what the all-gather ships."""
    w_at = _table_on(w, "dense mixer")

    def gather(leaves):
        _check_block(leaves, block)
        mix.shipped_nbytes = group.n_agents * _nbytes(leaves)
        return gather_blocks(group, leaves)

    def mix(tree, t=None):
        leaves, treedef = tree_flatten(tree)
        w_t = w_at(leaves[0].device, t)
        return treedef.unflatten([group.rows(_mix_leaf(w_t, f))
                                  for f in gather(leaves)])

    def push(tree, wvec, t=None):
        leaves, treedef = tree_flatten(tree)
        *full, full_w = gather(leaves + [wvec])
        w_t = w_at(wvec.device, t)
        w_m = (w_t @ full_w.to(torch.float32)).to(wvec.dtype)
        return (treedef.unflatten([group.rows(_mix_leaf(w_t, f))
                                   for f in full]), group.rows(w_m))

    mix.push = push
    mix.time_varying = w_at.time_varying
    mix.shipped_nbytes = 0
    mix.budget = GossipBudget(
        "dense", {"all-gather": 1},
        note="the reference's partitioner chooses its collectives; here "
        "one all-gather of every leaf")
    return mix


def make_ring_process_mixer(w, group) -> MixFn:
    """Banded-W gossip with one agent a rank: a shift of all leaves to each
    live neighbour (one point-to-point exchange a band), then ``w_self c_i
    + w_prev c_{i-1} + w_next c_{i+1}`` as :func:`make_ring_mixer` adds it,
    band weights and dtypes alike.  On a ``(pod, data)`` grid the shifts go
    straight to the global ring neighbour, which is what the reference's
    seam patch computes with two shifts.  ``mix.push`` ships the (1,) f32
    push-sum weight in the same messages.  ``mix.shipped_nbytes``: the
    bytes this rank sent in the last call."""
    bands_at, use_prev, use_next = _ring_bands(w, "ring mixer")
    live = int(use_prev) + int(use_next)

    def neighbours(tensors):
        _check_block(tensors)
        none = [None] * len(tensors)
        prev = group.shift(tensors, +1) if use_prev else none
        nxt = group.shift(tensors, -1) if use_next else none
        mix.shipped_nbytes = live * _nbytes(tensors)
        return prev, nxt

    def mixed(leaves, prev, nxt, t, f32: bool):
        return [_ring_sum(leaf, bands_at(leaf.device, torch.float32 if f32
                                         else leaf.dtype, t), p, q)
                .to(leaf.dtype) for leaf, p, q in zip(leaves, prev, nxt)]

    def mix(tree, t=None):
        leaves, treedef = tree_flatten(tree)
        prev, nxt = neighbours(leaves)
        return treedef.unflatten(mixed(leaves, prev, nxt, t, False))

    def push(tree, wvec, t=None):
        leaves, treedef = tree_flatten(tree)
        prev, nxt = neighbours(leaves + [wvec])
        bands = bands_at(wvec.device, torch.float32, t)
        w_m = _ring_sum(wvec, bands, prev[-1], nxt[-1]).to(wvec.dtype)
        return (treedef.unflatten(mixed(leaves, prev[:-1], nxt[:-1], t,
                                        True)), w_m)

    mix.push = push
    mix.time_varying = bands_at.time_varying
    mix.shipped_nbytes = 0
    mix.budget = reference_budget(
        "ring", live, axes=len(group.axes), note="the reference shifts "
        "once a band and axis, here once a band, all leaves and the "
        "push-sum weight in one message")
    return mix


def make_packed_process_mixer(w, frac: float, group) -> MixFn:
    """W @ c over top-k (value, int32 index) pairs with one agent a rank:
    the rank's pairs of every leaf (as :func:`make_packed_mixer` keeps
    them) go out in one all-gather, and the rank scatter-adds every
    sender's pairs times its row of ``W_t``, senders in order.
    ``mix.shipped_nbytes``: every agent's pairs, what the all-gather
    ships."""
    w_at = _table_on(w, "packed mixer")
    k_b = max(int(round(frac * PACK_BLOCK)), 1)
    n = group.n_agents

    def mix(tree, t=None):
        leaves, treedef = tree_flatten(tree)
        _check_block(leaves)
        pairs = [p for leaf in leaves for p in _topk_pairs(leaf, k_b)]
        full = group.all_gather(pairs)
        mix.shipped_nbytes = n * _nbytes(pairs)
        w_row = group.rows(w_at(leaves[0].device, t))          # (1, n)
        return treedef.unflatten([
            _scatter_pairs(leaf, full[2 * i][:, 0], full[2 * i + 1][:, 0],
                           w_row) for i, leaf in enumerate(leaves)])

    mix.time_varying = w_at.time_varying
    mix.shipped_nbytes = 0
    mix.budget = reference_budget(
        "packed", note="the (values, indices) of every leaf in one "
        "all-gather")
    return mix


def draw_blocks(full, n_agents: int, nbs, shards=None):
    """A global codec row matrix ``full`` (a qsgd draw) cut leaf by leaf:
    leaf l is ``(n_agents, shards[l], nbs[l], PACK_BLOCK)``, agent-major,
    then model shard, then window (``shards`` None: one a leaf).  The one
    layout of the draw, for a rank's block (:func:`_rank_windows`) and for
    the one-card twin (``launch.steps.codec_on_one_card``)."""
    shards = [1] * len(nbs) if shards is None else shards
    out, off = [], 0
    for nb, m in zip(nbs, shards):
        size = n_agents * m * nb
        out.append(full[off:off + size].reshape(n_agents, m, nb, PACK_BLOCK))
        off += size
    return out


def draw_rows(n_agents: int, nbs, shards=None) -> int:
    """The rows of the global draw :func:`draw_blocks` cuts."""
    shards = [1] * len(nbs) if shards is None else shards
    return n_agents * sum(nb * m for nb, m in zip(nbs, shards))


def _rank_windows(full, group, nbs, shards=None):
    """This rank's rows of a global codec row matrix ``full`` laid out as
    :func:`draw_blocks` says: this agent's block of this rank's shard (of
    shard 0 for a replicated leaf, which every model rank packs whole)."""
    m_idx = getattr(group, "model_index", 0)
    parts = [b[group.index, m_idx if b.shape[1] > 1 else 0]
             for b in draw_blocks(full, group.n_agents, nbs, shards)]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _pack_rank(codec: WireFormat, group, gen, leaves, noise, shards=None):
    """Pack this rank's windows of every leaf once: -> (buffers, windows a
    leaf).  A qsgd codec draws the global noise of every agent's windows
    from ``gen`` -- on a model axis of every (agent, model shard) pair's
    windows, ``shards[l]`` shards of leaf l (:func:`_rank_windows`'
    order) -- or takes it injected at that global shape, and keeps this
    rank's rows: each shard packs with its block of one draw, so a run on
    processes is bitwise the one-card twin that packs every shard's
    windows with the same draw (``launch.steps.codec_on_one_card``)."""
    _check_block(leaves)
    windows = [to_windows(leaf.reshape(1, -1).to(torch.float32))
               .reshape(-1, PACK_BLOCK) for leaf in leaves]
    rows = torch.cat(windows) if len(windows) > 1 else windows[0]
    nbs = [win.shape[0] for win in windows]
    if not codec.deterministic:
        if noise is None:
            noise = torch.rand((draw_rows(group.n_agents, nbs, shards),
                                PACK_BLOCK), generator=gen,
                               device=rows.device)
        noise = _rank_windows(noise, group, nbs, shards)
    return codec.pack(rows, noise), nbs


def _unpack_sets(codec: WireFormat, sets):
    """Unpack several agents' buffer sets in one call: -> each set's
    ``(R, PACK_BLOCK)`` f32 rows.  Every window unpacks on its own."""
    if len(sets) == 1:
        return [codec.unpack(*sets[0])]
    bufs = [torch.cat(parts) for parts in zip(*sets)]
    return list(codec.unpack(*bufs).chunk(len(sets)))


def make_ring_codec_process_mixer(w, codec: WireFormat, group,
                                  shards=None) -> MixFn:
    """Banded-W gossip over bit-packed buffers with one agent a rank: the
    rank packs its windows once, ships the buffers to each live neighbour
    (one exchange a band), unpacks its own and the received ones in one
    call, and adds ``b_self c + b_prev c_prev + b_next c_next`` in f32 as
    :func:`make_ring_codec_mixer` does.  ``exchange_ps`` appends the (1,)
    f32 weight increment to the last buffer.  ``shards``: each leaf's model
    shards on a model axis (1 for a replicated leaf), the layout of a
    randomized codec's global draw (:func:`_pack_rank`).  ``mix.shipped_nbytes``: the
    bytes this rank sent in the last exchange."""
    bands_at, use_prev, use_next = _ring_bands(w, "ring codec mixer")
    live = int(use_prev) + int(use_next)

    def mix(*a, **k):
        _codec_mix_error()

    def _exchange(gen, tree, t, noise, dw):
        leaves, treedef = tree_flatten(tree)
        bufs, nbs = _pack_rank(codec, group, gen, leaves, noise, shards)
        if dw is not None:
            bufs, last_shape = _append_weight(bufs, dw)
        sets = [bufs]
        if use_prev:
            sets.append(group.shift(bufs, +1))   # agent i - 1's buffers
        if use_next:
            sets.append(group.shift(bufs, -1))
        mix.shipped_nbytes = live * _nbytes(bufs)
        if dw is not None:
            sets, ws = zip(*(_split_weight(b, last_shape, 1) for b in sets))
        rows = _unpack_sets(codec, sets)
        bands = bands_at(rows[0].device, torch.float32, t)

        def ring(parts):
            return _ring_sum(parts[0], bands,
                             parts[1] if use_prev else None,
                             parts[-1] if use_next else None)

        cs, wcs, start = [], [], 0
        for leaf, nb in zip(leaves, nbs):
            parts = [r[start:start + nb].reshape(1, -1)[:, :leaf[0].numel()]
                     for r in rows]
            start += nb
            cs.append(parts[0].reshape(leaf.shape).to(leaf.dtype))
            wcs.append(ring(parts).reshape(leaf.shape).to(leaf.dtype))
        out = treedef.unflatten(cs), treedef.unflatten(wcs)
        if dw is None:
            return out
        return out + (ws[0].to(dw.dtype), ring(ws).to(dw.dtype))

    mix.exchange = lambda gen, tree, t=None, noise=None: _exchange(
        gen, tree, t, noise, None)
    mix.exchange_ps = lambda gen, tree, dw, t=None, noise=None: _exchange(
        gen, tree, t, noise, dw)
    mix.time_varying = bands_at.time_varying
    mix.wire_codec = codec
    mix.shipped_nbytes = 0
    mix.budget = reference_budget(
        "ring_codec", live, len(group.axes), note="every buffer of "
        "a band in one message, the weight words in the last buffer")
    return mix


def make_packed_codec_process_mixer(w, codec: WireFormat, group,
                                    shards=None) -> MixFn:
    """All-gather gossip over bit-packed buffers with one agent a rank: the
    rank packs its windows once and all-gathers the buffers (the weight
    words appended to the last one by ``exchange_ps``); every agent's
    windows unpack in one call and go back into the one-card row order,
    and the rank keeps its row of the whole ``W_t @ c``, as
    :func:`make_dense_process_mixer` does and for the same reason.
    ``shards``: as :func:`make_ring_codec_process_mixer`'s.
    ``mix.shipped_nbytes``: every agent's buffers, what the all-gather
    ships."""
    w_at = _table_on(w, "packed codec mixer")
    n = group.n_agents

    def mix(*a, **k):
        _codec_mix_error()

    def _exchange(gen, tree, t, noise, dw):
        leaves, treedef = tree_flatten(tree)
        bufs, nbs = _pack_rank(codec, group, gen, leaves, noise, shards)
        if dw is not None:
            bufs, last_shape = _append_weight(bufs, dw)
        full = group.all_gather(bufs)                    # each (n, ...)
        mix.shipped_nbytes = n * _nbytes(bufs)
        if dw is not None:
            last = full[-1]
            nw = last.shape[1] - math.prod(last_shape)
            words = last[:, last.shape[1] - nw:].contiguous()
            cw = words.view(torch.float32).reshape(n)
            full = full[:-1] + [last[:, :last.shape[1] - nw]
                                .reshape((n,) + tuple(last_shape))]
        flat = [b.reshape((-1,) + tuple(b.shape[2:])) for b in full]
        unpacked = codec.unpack(*flat).reshape(n, -1, PACK_BLOCK)
        parts, off = [], 0
        for nb in nbs:                      # the one-card row order
            parts.append(unpacked[:, off:off + nb].reshape(-1, PACK_BLOCK))
            off += nb
        c_rows = torch.cat(parts) if len(parts) > 1 else parts[0].contiguous()
        w_t = w_at(c_rows.device, t)
        cs, wcs, start = [], [], 0
        for leaf, nb in zip(leaves, nbs):
            c_leaf = c_rows[start:start + n * nb].reshape(n, -1)
            c_leaf = c_leaf[:, :leaf[0].numel()]
            start += n * nb
            cs.append(group.rows(c_leaf).reshape(leaf.shape).to(leaf.dtype))
            wcs.append(group.rows(w_t @ c_leaf).reshape(leaf.shape)
                       .to(leaf.dtype))
        out = treedef.unflatten(cs), treedef.unflatten(wcs)
        if dw is None:
            return out
        return out + (group.rows(cw).to(dw.dtype),
                      group.rows(w_t @ cw).to(dw.dtype))

    mix.exchange = lambda gen, tree, t=None, noise=None: _exchange(
        gen, tree, t, noise, None)
    mix.exchange_ps = lambda gen, tree, dw, t=None, noise=None: _exchange(
        gen, tree, t, noise, dw)
    mix.time_varying = w_at.time_varying
    mix.wire_codec = codec
    mix.shipped_nbytes = 0
    mix.budget = reference_budget(
        "packed_codec", note="every buffer in one all-gather, "
        "the weight words in the last buffer")
    return mix


def make_mixer(topology: Union[Topology, TopologySchedule],
               mode: str = "dense", frac: Optional[float] = None,
               codec: Optional[WireFormat] = None, group=None,
               sharded=None) -> MixFn:
    """The gossip executor for a static :class:`Topology` or a
    :class:`TopologySchedule` (whose ``(period, n, n)`` table the mixer
    indexes with the round), tagged with its ``wire_mode`` (and
    ``wire_frac``) so the comm-round engine accounts its bytes, and with
    ``schedule`` (None for a static topology).

    ``mode``: "dense" (:func:`make_dense_mixer`), "ring" (a ring band, or
    a schedule of them: :func:`make_ring_mixer`) or "packed" (top-k pairs
    at ``frac``: :func:`make_packed_mixer`).  ``codec``: a
    :class:`WireFormat`; with it "ring" and "packed" become the codec
    executors (:func:`make_ring_codec_mixer`,
    :func:`make_packed_codec_mixer`; drive them through ``mix.exchange``).
    Dense gossip has no codec form.  ``group``: None, every agent on one
    card; or a :class:`repro_torch.launch.mesh.AgentGroup`, one agent a
    rank, which picks the executors across processes
    (:func:`make_dense_process_mixer` and its siblings; the reference
    dispatches on ``mesh``).  ``sharded``: the per-shard layout on a
    grid with a model axis (a :class:`repro_torch.kernels.flatten.
    ShardedFlatSpec`), which tells a randomized codec's process executor
    each leaf's shards (the reference's ``leaf_specs=``).  Every executor
    carries the reference's ``budget``; ``mix.group`` and ``mix.n_agents``
    name the agents.
    """
    schedule = topology if isinstance(topology, TopologySchedule) else None
    w = schedule.ws if schedule is not None else topology.w
    n = np.asarray(w).shape[-1]
    if group is not None and group.n_agents != n:
        raise ValueError(f"the topology has {n} agents, the group "
                         f"{group.n_agents} ranks: one agent a rank")
    proc = group is not None
    shards = None if sharded is None else sharded.shards()
    if mode == "dense":
        if codec is not None:
            raise ValueError(
                "dense gossip ships the dense emulation by definition; "
                "bit-packed wire formats need gossip mode 'ring' or "
                "'packed'")
        mix = make_dense_process_mixer(w, group) if proc else make_dense_mixer(w)
    elif mode == "ring":
        if schedule is not None and not schedule.is_banded_ring():
            raise ValueError(
                f"schedule {schedule.kind!r} has rounds that are not "
                "circulant ring bands; the ring wire format only supports "
                "weight-varying ring schedules -- use dense or packed "
                "gossip for churn/resampling schedules")
        if codec is None:
            mix = (make_ring_process_mixer(w, group) if proc
                   else make_ring_mixer(w))
        else:
            mix = (make_ring_codec_process_mixer(w, codec, group, shards)
                   if proc else make_ring_codec_mixer(w, codec))
    elif mode == "packed":
        if codec is not None:
            mix = (make_packed_codec_process_mixer(w, codec, group, shards)
                   if proc else make_packed_codec_mixer(w, codec))
        elif frac is None:
            raise ValueError("packed gossip needs a top-k fraction")
        else:
            mix = (make_packed_process_mixer(w, frac, group) if proc
                   else make_packed_mixer(w, frac))
    else:
        raise ValueError(f"unknown gossip mode {mode!r}")
    mix.wire_mode = mode
    mix.wire_frac = frac
    mix.schedule = schedule
    mix.group = group
    mix.n_agents = n
    return mix


def gossip_wire_bytes(mode: str, n_agents: int, d_params: int,
                      frac: float = 1.0, dtype_bytes: int = 4) -> float:
    """Per-round bytes crossing agent links for one buffer (model-level)."""
    if mode == "dense":
        return float(n_agents) * d_params * dtype_bytes
    if mode == "ring":
        # n=2 folds both bands onto the single neighbor (one shift)
        shifts = 1.0 if n_agents == 2 else 2.0
        return shifts * d_params * dtype_bytes
    if mode == "packed":
        nb = -(-int(d_params) // PACK_BLOCK)          # windows after padding
        return float(n_agents) * nb * topk_keep(frac) * (dtype_bytes + 4)
    raise ValueError(mode)


def make_codec_compress(codec: WireFormat):
    """A deterministic codec's round trip as a compressor ``(gen, tree) ->
    tree``: every leaf flattened per agent, padded to its own PACK_BLOCK
    windows, packed and unpacked, trimmed and cast back -- the ``c`` a
    codec executor applies, without the gossip (so that a dense mixer
    beside it gives the codec executor's ``W c``)."""
    if not codec.deterministic:
        raise ValueError("make_codec_compress takes a deterministic codec")

    def compress(gen, tree):
        del gen
        leaves, treedef = tree_flatten(tree)
        out = []
        for leaf in leaves:
            n = leaf.shape[0]
            rows = to_windows(leaf.reshape(n, -1).to(torch.float32))
            c = codec.unpack(*codec.pack(rows.reshape(-1, PACK_BLOCK), None))
            c = c.reshape(n, -1)[:, :leaf[0].numel()]
            out.append(c.reshape(leaf.shape).to(leaf.dtype))
        return treedef.unflatten(out)

    return compress
