"""Gossip (neighbor mixing) over agent-stacked trees: the dense executor.

PORTER communicates increments: every agent sends ``c_i = C(y_i - q_i)``,
accumulates its surrogate ``q_i += c_i`` and its mixing mirror
``m_i += sum_j w_ij c_j``.  On one card the dense executor is the whole
story: ``W @ c`` over the leading agent axis as one f32 matrix product per
leaf (``src/repro/core/gossip.py::make_dense_mixer``, static form).
Schedules (``W_t``), push-sum's ``.push`` and the ring / packed executors
wait for later slices (ROADMAP queue 1 items 3, 4 and 12).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..tree import tree_map
from .mixing import Topology

__all__ = ["MixFn", "PACK_BLOCK", "apply_mixer", "make_dense_mixer",
           "make_mixer", "gossip_wire_bytes"]

MixFn = Callable[..., object]

# the packed wire format's selection window (the reference's
# core/wire_formats.PACK_BLOCK); used only by the byte model here
PACK_BLOCK = 2048


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


def make_dense_mixer(w) -> MixFn:
    """``tree -> W @ tree`` over the agent axis, in f32.

    ``w``: a static (n, n) matrix.  It is kept in float64 numpy and cast to
    f32 once per device, on first use, so building a mixer touches no
    device.
    """
    w_np = np.asarray(w, dtype=np.float64)
    if w_np.ndim != 2:
        raise ValueError(
            f"the dense mixer takes a static (n, n) matrix, got shape "
            f"{w_np.shape}; (period, n, n) schedules come with a later slice "
            "(ROADMAP queue 1 item 3)")
    on_device: Dict[torch.device, torch.Tensor] = {}

    def w_on(device: torch.device) -> torch.Tensor:
        w_dev = on_device.get(device)
        if w_dev is None:
            w_dev = on_device[device] = torch.as_tensor(
                w_np, dtype=torch.float32).to(device)
        return w_dev

    def mix(tree, t=None):
        del t  # static
        return tree_map(lambda leaf: _mix_leaf(w_on(leaf.device), leaf), tree)

    mix.time_varying = False
    return mix


def make_mixer(topology: Topology, mode: str = "dense") -> MixFn:
    """The gossip executor for ``topology``, tagged with its ``wire_mode``
    so the comm-round engine accounts its bytes.  Dense only in this slice."""
    if mode != "dense":
        raise ValueError(
            f"gossip mode {mode!r} is not ported yet; this slice has the "
            "dense executor only (ring and packed: ROADMAP queue 1 item 12)")
    mix = make_dense_mixer(topology.w)
    mix.wire_mode = mode
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
        k_b = max(int(round(frac * PACK_BLOCK)), 1)   # pairs per window
        return float(n_agents) * nb * k_b * (dtype_bytes + 4)
    raise ValueError(mode)
