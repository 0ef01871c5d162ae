"""Gossip (neighbor mixing) over agent-stacked trees on one card.

PORTER communicates increments: every agent sends ``c_i = C(y_i - q_i)``,
accumulates its surrogate ``q_i += c_i`` and its mixing mirror
``m_i += sum_j w_ij c_j``.  Two executors (``src/repro/core/gossip.py``):

* dense: ``W @ c`` over the leading agent axis, one f32 matrix product per
  leaf (``make_dense_mixer``);
* packed codec (``wire="packed_bits"``): every agent packs its increment
  into the bit-packed buffers of a :class:`WireFormat`, and every agent
  unpacks every sender's buffers (``make_packed_codec_mixer``).  The
  reference runs it as a ``shard_map`` program with one agent per device
  and an all-gather of the buffers; on one card all agents sit in one
  tensor, the all-gather is the identity, and each agent's buffers are
  packed once and unpacked once.

Time-varying topologies: both executors take a static ``(n, n)`` matrix or
a stacked ``(period, n, n)`` schedule table.  A table's mixer is tagged
``time_varying`` and takes the absolute round index ``t`` (the state's
step, a host ``int``): ``W_t`` is ``table[t % period]`` of an f32 copy of
the table kept on each device it is used on, so picking it costs no copy
from the host and no sync.

Push-sum (directed, column-stochastic W): the dense executor's
``mix.push(tree, wvec, t)`` also mixes the ``(n,)`` push-sum weight with
the same ``W_t``; the codec executor's ``mix.exchange_ps(gen, tree, dw, t)``
carries the exact f32 weight increment as bit-cast words appended to its
last wire buffer (4 bytes an agent).  The weight is never compressed.

The ring executors and the packed executor without a codec wait for a
later slice (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..tree import tree_flatten, tree_map
from .mixing import Topology, TopologySchedule
from .wire_formats import PACK_BLOCK, WireFormat, to_windows, topk_keep

__all__ = ["MixFn", "GossipBudget", "PACK_BLOCK", "apply_mixer",
           "make_dense_mixer", "make_packed_codec_mixer", "make_mixer",
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
    so far (no per-leaf collectives); the other executors get theirs with
    the collective census (ROADMAP queue 1 item 14).
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


def make_packed_codec_mixer(w, codec: WireFormat) -> MixFn:
    """Gossip over bit-packed buffers, all agents on one card.

    ``mix.exchange(gen, delta, t=None, noise=None) -> (c, wc)``: every leaf
    is flattened per agent and padded to its own PACK_BLOCK windows, as the
    reference's ``_pack_local`` pads each leaf; all leaves' windows stack
    into one ``(R, PACK_BLOCK)`` f32 row matrix (leaf by leaf in tree order,
    agent by agent within a leaf), which is packed once and unpacked once.
    ``c`` is the unpacked increment in each leaf's dtype; ``wc = W_t @ c``
    is the f32 product of the unpacked rows, then cast, as the reference's
    receive side sums f32 unpacked buffers.  ``w`` is a static (n, n)
    matrix or a (period, n, n) schedule table (then ``t`` is required).
    A qsgd codec draws its U[0, 1) noise for all R rows from ``gen`` in one
    call; ``noise=`` injects it (the parity tests hand over the
    reference's uniforms).

    ``mix.exchange_ps(gen, delta, dw, t=None, noise=None) -> (c, wc, cw,
    wcw)``: the same exchange, with the (n,) f32 push-sum weight increments
    ``dw`` bit-cast into the last buffer (4 bytes an agent, as the
    reference appends each agent's weight to its own last buffer); ``cw``
    is what came off the wire, bitwise ``dw``, and ``wcw = W_t @ cw``.

    ``mix.shipped_nbytes`` holds the nbytes of the buffers the last
    exchange shipped: all agents' buffers, what the all-gather ships.
    """
    w_at = _table_on(w, "packed codec mixer")

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
        mix.shipped_nbytes = sum(b.numel() * b.element_size() for b in bufs)
        if dw is not None:
            bufs, cw = _split_weight(bufs, last_shape, n)
        c_rows = codec.unpack(*bufs)
        w_t = w_at(rows.device, t)
        cs, wcs, start = [], [], 0
        for leaf, win in zip(leaves, windows):
            c_leaf = c_rows[start:start + win.shape[0]].reshape(n, -1)
            c_leaf = c_leaf[:, :leaf[0].numel()]
            start += win.shape[0]
            cs.append(c_leaf.reshape(leaf.shape).to(leaf.dtype))
            wcs.append((w_t @ c_leaf).reshape(leaf.shape).to(leaf.dtype))
        out = treedef.unflatten(cs), treedef.unflatten(wcs)
        if dw is None:
            return out
        return out + (cw.to(dw.dtype), (w_t @ cw).to(dw.dtype))

    def exchange(gen, tree, t=None, noise=None):
        return _exchange(gen, tree, t, noise, None)

    def exchange_ps(gen, tree, dw, t=None, noise=None):
        return _exchange(gen, tree, t, noise, dw)

    mix.exchange = exchange
    mix.exchange_ps = exchange_ps
    mix.time_varying = w_at.time_varying
    mix.wire_codec = codec
    mix.shipped_nbytes = 0
    return mix


def make_mixer(topology: Union[Topology, TopologySchedule],
               mode: str = "dense", frac: Optional[float] = None,
               codec: Optional[WireFormat] = None) -> MixFn:
    """The gossip executor for a static :class:`Topology` or a
    :class:`TopologySchedule` (whose ``(period, n, n)`` table the mixer
    indexes with the round), tagged with its ``wire_mode`` (and
    ``wire_frac``) so the comm-round engine accounts its bytes, and with
    ``schedule`` (None for a static topology).

    ``codec``: a :class:`WireFormat`; with ``mode="packed"`` the executor
    is the packed codec mixer (drive it through ``mix.exchange``).  Dense
    gossip has no codec form.  The ring executors and the packed executor
    without a codec are not ported yet.
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
    elif mode == "packed" and codec is not None:
        mix = make_packed_codec_mixer(w, codec)
    elif mode in ("ring", "packed"):
        raise ValueError(
            f"gossip mode {mode!r} is not ported yet"
            + (" without a codec" if mode == "packed" else "")
            + "; this slice has the dense executor and the packed codec "
            "executor (ring and plain packed: ROADMAP queue 1 item 12)")
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
