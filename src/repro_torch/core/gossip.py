"""Gossip (neighbor mixing) over agent-stacked trees on one card.

PORTER communicates increments: every agent sends ``c_i = C(y_i - q_i)``,
accumulates its surrogate ``q_i += c_i`` and its mixing mirror
``m_i += sum_j w_ij c_j``.  Two executors (``src/repro/core/gossip.py``,
static forms):

* dense: ``W @ c`` over the leading agent axis, one f32 matrix product per
  leaf (``make_dense_mixer``);
* packed codec (``wire="packed_bits"``): every agent packs its increment
  into the bit-packed buffers of a :class:`WireFormat`, and every agent
  unpacks every sender's buffers (``make_packed_codec_mixer``).  The
  reference runs it as a ``shard_map`` program with one agent per device
  and an all-gather of the buffers; on one card all agents sit in one
  tensor, the all-gather is the identity, and each agent's buffers are
  packed once and unpacked once.

Schedules (``W_t``), push-sum's ``.push``, the ring executors and the
packed executor without a codec wait for later slices (ROADMAP queue 1
items 3, 4, 8 and 12).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..tree import tree_flatten, tree_map
from .mixing import Topology
from .wire_formats import PACK_BLOCK, WireFormat, to_windows, topk_keep

__all__ = ["MixFn", "PACK_BLOCK", "apply_mixer", "make_dense_mixer",
           "make_packed_codec_mixer", "make_mixer", "gossip_wire_bytes"]

MixFn = Callable[..., object]


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


def _static_w(w, what: str):
    """For a static (n, n) matrix ``w``: a function giving its f32 copy on a
    device, made there on first use (building a mixer touches no device)."""
    w_np = np.asarray(w, dtype=np.float64)
    if w_np.ndim != 2:
        raise ValueError(
            f"the {what} takes a static (n, n) matrix, got shape "
            f"{w_np.shape}; (period, n, n) schedules come with a later slice "
            "(ROADMAP queue 1 item 3)")
    on_device: Dict[torch.device, torch.Tensor] = {}

    def w_on(device: torch.device) -> torch.Tensor:
        w_dev = on_device.get(device)
        if w_dev is None:
            w_dev = on_device[device] = torch.as_tensor(
                w_np, dtype=torch.float32).to(device)
        return w_dev

    return w_on


def make_dense_mixer(w) -> MixFn:
    """``tree -> W @ tree`` over the agent axis, in f32."""
    w_on = _static_w(w, "dense mixer")

    def mix(tree, t=None):
        del t  # static
        return tree_map(lambda leaf: _mix_leaf(w_on(leaf.device), leaf), tree)

    mix.time_varying = False
    return mix


def _codec_mix_error(*a, **k):
    raise ValueError(
        "codec gossip executors fuse compression with packing and return "
        "(c, wc); call mix.exchange(key, tree, t) -- the CommRound engine "
        "does this -- instead of mixing a pre-compressed tree")


def make_packed_codec_mixer(w, codec: WireFormat) -> MixFn:
    """Gossip over bit-packed buffers, all agents on one card.

    ``mix.exchange(gen, delta, t=None, noise=None) -> (c, wc)``: every leaf
    is flattened per agent and padded to its own PACK_BLOCK windows, as the
    reference's ``_pack_local`` pads each leaf; all leaves' windows stack
    into one ``(R, PACK_BLOCK)`` f32 row matrix (leaf by leaf in tree order,
    agent by agent within a leaf), which is packed once and unpacked once.
    ``c`` is the unpacked increment in each leaf's dtype; ``wc = W @ c`` is
    the f32 product of the unpacked rows, then cast, as the reference's
    receive side sums f32 unpacked buffers.  A qsgd codec draws its U[0, 1)
    noise for all R rows from ``gen`` in one call; ``noise=`` injects it
    (the parity tests hand over the reference's uniforms).
    ``mix.shipped_nbytes`` holds the nbytes of the buffers the last
    exchange packed: all agents' buffers, what the all-gather ships.
    """
    w_on = _static_w(w, "packed codec mixer")

    def mix(*a, **k):
        _codec_mix_error()

    def exchange(gen, tree, t=None, noise=None):
        del t  # static
        leaves, treedef = tree_flatten(tree)
        n = leaves[0].shape[0]
        windows = [to_windows(leaf.reshape(n, -1).to(torch.float32))
                   .reshape(-1, PACK_BLOCK) for leaf in leaves]
        rows = torch.cat(windows) if len(windows) > 1 else windows[0]
        if noise is None and not codec.deterministic:
            noise = torch.rand(rows.shape, generator=gen, device=rows.device)
        bufs = codec.pack(rows, noise)
        mix.shipped_nbytes = sum(b.numel() * b.element_size()
                                            for b in bufs)
        c_rows = codec.unpack(*bufs)
        w_dev = w_on(rows.device)
        cs, wcs, start = [], [], 0
        for leaf, win in zip(leaves, windows):
            c_leaf = c_rows[start:start + win.shape[0]].reshape(n, -1)
            c_leaf = c_leaf[:, :leaf[0].numel()]
            start += win.shape[0]
            cs.append(c_leaf.reshape(leaf.shape).to(leaf.dtype))
            wcs.append((w_dev @ c_leaf).reshape(leaf.shape).to(leaf.dtype))
        return treedef.unflatten(cs), treedef.unflatten(wcs)

    mix.exchange = exchange
    mix.time_varying = False
    mix.wire_codec = codec
    mix.shipped_nbytes = 0
    return mix


def make_mixer(topology: Topology, mode: str = "dense",
               frac: Optional[float] = None,
               codec: Optional[WireFormat] = None) -> MixFn:
    """The gossip executor for ``topology``, tagged with its ``wire_mode``
    (and ``wire_frac``) so the comm-round engine accounts its bytes.

    ``codec``: a :class:`WireFormat`; with ``mode="packed"`` the executor
    is the packed codec mixer (drive it through ``mix.exchange``).  Dense
    gossip has no codec form.  The ring executors and the packed executor
    without a codec are not ported yet.
    """
    if mode == "dense":
        if codec is not None:
            raise ValueError(
                "dense gossip ships the dense emulation by definition; "
                "bit-packed wire formats need gossip mode 'ring' or "
                "'packed'")
        mix = make_dense_mixer(topology.w)
    elif mode == "packed" and codec is not None:
        mix = make_packed_codec_mixer(topology.w, codec)
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
