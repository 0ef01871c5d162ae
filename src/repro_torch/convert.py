"""Carry weights and state between numpy and the port.

The bridge the parity tests use: the reference's arrays go through numpy
(``np.asarray`` of any array, no framework import here) into the port's
dicts of tensors, and back.

* :func:`to_torch` / :func:`to_numpy` -- a tree of arrays <-> the same tree
  of tensors (dicts, tuples, lists and NamedTuples keep their structure).
* :func:`state_to_torch` / :func:`state_to_numpy` -- a ``PorterState``-
  shaped namedtuple of arrays (fields ``x, v, q_x, q_v, g_prev, m_x, m_v,
  step``) <-> the port's :class:`~repro_torch.core.porter.PorterState`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.porter import PorterState
from .tree import tree_map

__all__ = ["to_torch", "to_numpy", "state_to_torch", "state_to_numpy"]

_BUFFERS = ("x", "v", "q_x", "q_v", "g_prev", "m_x", "m_v")


def to_torch(tree, device=None):
    """Copy a tree of arrays into tensors on ``device`` (cuda unless given)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def to_numpy(tree):
    """Copy a tree of tensors back to numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def state_to_torch(state, device=None) -> PorterState:
    """A PorterState-shaped namedtuple of arrays -> the port's state."""
    bufs = {f: to_torch(getattr(state, f), device) for f in _BUFFERS}
    return PorterState(**bufs, step=int(np.asarray(state.step)))


def state_to_numpy(state: PorterState) -> PorterState:
    """The port's state -> a PorterState of numpy arrays (step as int32)."""
    bufs = {f: to_numpy(getattr(state, f)) for f in _BUFFERS}
    return PorterState(**bufs, step=np.int32(state.step))
