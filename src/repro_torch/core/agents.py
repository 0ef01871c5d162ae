"""An agent's rows of agent-major tensors.

Across processes (:class:`repro_torch.launch.mesh.AgentGroup`: one agent
a rank, or a fleet's block of k = n / ranks agents) every buffer holds the
rank's rows of the one-card tensor, rows ``[index * k, (index + 1) * k)``.
:func:`agent_rows` slices them out; :func:`local_rows` is the draw sites'
form: a rank draws the global shape from the round's generator and keeps
its own rows, so a run across processes draws what the one-card run draws
(a JAX draw does not depend on sharding either).  On a grid with a
model axis a draw in a model-sharded leaf's shape also keeps the rank's
shard along that leaf's sharded dimension (``dim``), so the shards of one
agent hold slices of one draw, never draws of their own.  ``group`` is
anything with ``index`` and ``n_agents`` (and ``model_size`` /
``model_index`` for ``dim``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["agent_rows", "model_shard", "local_rows"]


def agent_rows(full: torch.Tensor, index: int, n_agents: int,
               per_agent: Optional[int] = None) -> torch.Tensor:
    """Agent ``index``'s rows of an agent-major tensor: rows ``[index * r,
    (index + 1) * r)`` of ``full``, r = ``per_agent`` or ``len(full) /
    n_agents``."""
    r = full.shape[0] // n_agents if per_agent is None else per_agent
    return full[index * r:(index + 1) * r]


def model_shard(full: torch.Tensor, dim: Optional[int], index: int,
                size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` equal slices of ``full`` along ``dim``
    (``full`` itself when ``dim`` is None)."""
    if dim is None or size == 1:
        return full
    part = full.shape[dim] // size
    return full.narrow(dim, index * part, part)


def local_rows(group, shape: Sequence[int],
               draw: Callable[[Tuple[int, ...]], torch.Tensor],
               dim: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)``, or under ``group`` this agent's rows of ``draw``
    at the global shape (``shape[0]`` agent-major rows an agent, times
    ``n_agents``; and ``shape[dim]`` times the model axis when ``dim``, the
    local shape's model-sharded dimension, is given), with this rank's
    model shard along ``dim``.  The generator then advances as the
    one-card draw's, and the block is the one-card draw's block of this
    rank, copied out so the global draw is freed at once."""
    shape = tuple(shape)
    if group is None:
        return draw(shape)
    m = getattr(group, "model_size", 1)
    full_shape = [group.n_agents * shape[0], *shape[1:]]
    if dim is not None and m > 1:
        full_shape[dim] *= m
    full = draw(tuple(full_shape))
    rows = agent_rows(full, group.index, group.n_agents, shape[0])
    if dim is not None and m > 1:
        rows = model_shard(rows, dim, group.model_index, m)
    return rows.clone()
