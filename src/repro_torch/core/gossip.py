"""Gossip (neighbor mixing) over agent-stacked trees on one card.

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
all-gather for packed.  On one card all agents sit in one tensor: a shift
is a roll along the agent axis (the "prev" copy rolled by +1, agent i - 1
arriving at i; "next" by -1), the all-gather is the identity, and a codec
packs every agent's windows once and unpacks them once.  Each executor's
``shipped_nbytes`` holds the bytes of its last call's buffers, as the
reference's wire accounting counts them (the ring's for one agent, to its
live neighbours; packed's for all agents).

Time-varying topologies: every executor takes a static ``(n, n)`` matrix
or a stacked ``(period, n, n)`` schedule table.  A table's mixer is tagged
``time_varying`` and takes the absolute round index ``t`` (the state's
step, a host ``int``): ``W_t`` (the ring's three band weights) is row ``t
% period`` of an f32 copy of the table kept on each device it is used on,
so picking it costs no copy from the host and no sync.

Push-sum (directed, column-stochastic W): the dense and ring executors'
``mix.push(tree, wvec, t)`` also mixes the ``(n,)`` push-sum weight with
the same ``W_t``; the codec executors' ``mix.exchange_ps(gen, tree, dw,
t)`` carries the exact f32 weight increment as bit-cast words appended to
its last wire buffer (4 bytes an agent).  The weight is never compressed.
The plain packed executor ships (value, index) pairs only and has no
``push``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..tree import tree_flatten, tree_map
from .mixing import Topology, TopologySchedule
from .wire_formats import PACK_BLOCK, WireFormat, to_windows, topk_keep

__all__ = ["MixFn", "GossipBudget", "PACK_BLOCK", "apply_mixer",
           "make_dense_mixer", "make_ring_mixer", "make_packed_mixer",
           "make_ring_codec_mixer", "make_packed_codec_mixer", "make_mixer",
           "gossip_wire_bytes"]

MixFn = Callable[..., object]


@dataclasses.dataclass(frozen=True)
class GossipBudget:
    """Declared collective budget of one gossip executor (the reference's
    ``repro.core.gossip.GossipBudget``).

    ``per_leaf`` maps a collective category to the most such ops the
    executor may issue per gossiped leaf and comm round; a category
    absent from it is forbidden.  ``spmd_dependent`` marks executors whose
    collectives a partitioner chooses.  Only the fleet mixer carries one
    (no per-leaf collectives).  The other executors issue no collective on
    one card either (the ring's shifts are rolls, the packed all-gather is
    the identity); their budgets come with the processes that ship
    buffers (ROADMAP queue 1 item 12(b)) and the collective census that
    checks them (item 14).
    """

    executor: str
    per_leaf: "dict[str, int]" = dataclasses.field(default_factory=dict)
    spmd_dependent: bool = False
    note: str = ""


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


def _ring_sum(x, bands, use_prev: bool, use_next: bool):
    """``b_self x + b_prev roll(x, +1) + b_next roll(x, -1)`` over the
    leading agent axis, accumulated in that order in ``bands``' dtype (x
    converted to it) with the dead bands left out."""
    dt = bands[0].dtype
    x = x if x.dtype == dt else x.to(dt)
    out = bands[0] * x
    if use_prev:
        out = out + bands[1] * x.roll(1, 0)    # agent i - 1 arrives at i
    if use_next:
        out = out + bands[2] * x.roll(-1, 0)
    return out


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
            return _ring_sum(leaf, bands, use_prev, use_next).to(leaf.dtype)
        out = tree_map(leaf_mix, tree)
        leaves = tree_flatten(tree)[0]
        mix.shipped_nbytes = live * sum(
            leaf[0].numel() * leaf.element_size() for leaf in leaves)
        return out

    def mix(tree, t=None):
        return _mix(tree, t, False)

    def push(tree, wvec, t=None):
        bands = bands_at(wvec.device, torch.float32, t)
        w_m = _ring_sum(wvec, bands, use_prev, use_next).to(wvec.dtype)
        out = _mix(tree, t, True)
        mix.shipped_nbytes += live * 4          # the exact f32 weight
        return out, w_m

    mix.push = push
    mix.time_varying = bands_at.time_varying
    mix.shipped_nbytes = 0
    return mix


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
        n = leaf.shape[0]
        rows = to_windows(leaf.reshape(n, -1))             # (n, nb, block)
        idx = torch.sort(rows.abs(), dim=-1, descending=True,
                         stable=True).indices[..., :k_b]
        vals = torch.gather(rows, -1, idx)
        idx = idx.to(torch.int32)                # the wire's index words
        shipped = vals.numel() * vals.element_size() + idx.numel() * 4
        weighted = vals.to(torch.float32)
        out = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
        for j in range(n):
            out.scatter_add_(-1, idx[j].long().expand_as(out[..., :k_b]),
                             w_t[:, j, None, None] * weighted[j])
        out = out.reshape(n, -1)[:, :leaf[0].numel()]
        return out.reshape(leaf.shape).to(leaf.dtype), shipped

    def mix(tree, t=None):
        leaves, treedef = tree_flatten(tree)
        w_t = w_at(leaves[0].device, t)
        outs = [leaf_mix(leaf, w_t) for leaf in leaves]
        mix.shipped_nbytes = sum(o[1] for o in outs)
        return treedef.unflatten([o[0] for o in outs])

    mix.time_varying = w_at.time_varying
    mix.shipped_nbytes = 0
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
                 shipped) -> MixFn:
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
                        w_at.time_varying, lambda nbytes, n: nbytes)


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
        codec, lambda c, t: _ring_sum(c, bands_at(c.device, torch.float32, t),
                                      use_prev, use_next),
        bands_at.time_varying, lambda nbytes, n: live * nbytes // n)


def make_mixer(topology: Union[Topology, TopologySchedule],
               mode: str = "dense", frac: Optional[float] = None,
               codec: Optional[WireFormat] = None) -> MixFn:
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
    Dense gossip has no codec form.  Every agent sits on one card, so no
    mesh is needed.
    """
    schedule = topology if isinstance(topology, TopologySchedule) else None
    w = schedule.ws if schedule is not None else topology.w
    if mode == "dense":
        if codec is not None:
            raise ValueError(
                "dense gossip ships the dense emulation by definition; "
                "bit-packed wire formats need gossip mode 'ring' or "
                "'packed'")
        mix = make_dense_mixer(w)
    elif mode == "ring":
        if schedule is not None and not schedule.is_banded_ring():
            raise ValueError(
                f"schedule {schedule.kind!r} has rounds that are not "
                "circulant ring bands; the ring wire format only supports "
                "weight-varying ring schedules -- use dense or packed "
                "gossip for churn/resampling schedules")
        mix = (make_ring_mixer(w) if codec is None
               else make_ring_codec_mixer(w, codec))
    elif mode == "packed":
        if codec is not None:
            mix = make_packed_codec_mixer(w, codec)
        elif frac is None:
            raise ValueError("packed gossip needs a top-k fraction")
        else:
            mix = make_packed_mixer(w, frac)
    else:
        raise ValueError(f"unknown gossip mode {mode!r}")
    mix.wire_mode = mode
    mix.wire_frac = frac
    mix.schedule = schedule
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
