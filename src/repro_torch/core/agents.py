"""An agent's rows of agent-major tensors.

Across processes (one agent a rank, :class:`repro_torch.launch.mesh.
AgentGroup`) every buffer holds the rank's rows of the one-card tensor.
:func:`agent_rows` slices them out; :func:`local_rows` is the draw sites'
form: a rank draws the global shape from the round's generator and keeps
its own rows, so a run across processes draws what the one-card run draws
(a JAX draw does not depend on sharding either).  ``group`` is anything
with ``index`` and ``n_agents``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["agent_rows", "local_rows"]


def agent_rows(full: torch.Tensor, index: int, n_agents: int,
               per_agent: Optional[int] = None) -> torch.Tensor:
    """Agent ``index``'s rows of an agent-major tensor: rows ``[index * r,
    (index + 1) * r)`` of ``full``, r = ``per_agent`` or ``len(full) /
    n_agents``."""
    r = full.shape[0] // n_agents if per_agent is None else per_agent
    return full[index * r:(index + 1) * r]


def local_rows(group, shape: Sequence[int],
               draw: Callable[[Tuple[int, ...]], torch.Tensor]
               ) -> torch.Tensor:
    """``draw(shape)``, or under ``group`` this agent's rows of ``draw``
    at the global shape (``shape[0]`` agent-major rows an agent, times
    ``n_agents``).  The generator then advances as the one-card draw's,
    and the rows are the one-card draw's rows of this agent, copied out so
    the global draw is freed at once."""
    shape = tuple(shape)
    if group is None:
        return draw(shape)
    full = draw((group.n_agents * shape[0],) + shape[1:])
    return agent_rows(full, group.index, group.n_agents, shape[0]).clone()
