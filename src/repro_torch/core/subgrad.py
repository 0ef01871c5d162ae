"""Decentralized subgradient method with compressed gossip, ported from
``src/repro/core/subgrad.py`` (beyond the paper).

For nonsmooth objectives the classical subgradient scheme converges with a
diminishing stepsize; composed with a rho-compressor on the wire it is
CHOCO-SGD's round (``CommRound.gossip_apply``, the ``ef_gossip`` kernel)
with the stepsize ``eta / sqrt(t + 1)``:

    x_i^{t+1/2} = x_i^t - (eta / sqrt(t + 1)) * u_i^t,   u in d f_i(x_i^t)
    q / m / x by the engine's compressed surrogate gossip

Autograd at a kink returns one member of the subdifferential.  An optional
``tau`` clips the subgradient (the bounded-subgradient assumption
enforced).  The stepsize is an f32 scalar formed on the host from the
step, the reference's ``eta * rsqrt(f32(t) + 1)``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map
from .baselines import _agent_grads, _scalar
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn
from .porter import agent_metrics, replicas

__all__ = ["SubgradState", "subgrad_init", "subgrad_step"]


class SubgradState(NamedTuple):
    x: Any
    q: Any      # own surrogate x-hat
    m: Any      # mixing mirror: sum_j w_ij x-hat_j
    step: int


def subgrad_init(params, n_agents: int, plane_dtype=None) -> SubgradState:
    """CHOCO's layout: ``plane_dtype`` is the storage dtype of the
    surrogate and mirror (bf16 halves them)."""
    x = replicas(params, n_agents)
    dt = torch.float32 if plane_dtype is None else plane_dtype
    zeros = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=dt,
                                              device=leaf.device), x)
    return SubgradState(x=x, q=zeros, m=zeros, step=0)


def _stepsize(eta: float, step: int) -> float:
    """``eta / sqrt(step + 1)`` rounded as the reference's f32 product."""
    return float(np.float32(eta) * (np.float32(1.0)
                                    / np.sqrt(np.float32(step + 1))))


def subgrad_step(eta: float, gamma: float, loss_fn,
                 mixer: Optional[MixFn], compressor: Optional[Compressor],
                 state: SubgradState, batch, gen: Optional[torch.Generator],
                 tau: Optional[float] = None, clip_mode: str = "piecewise",
                 engine: Optional[CommRound] = None, grad_override=None,
                 ) -> Tuple[SubgradState, Dict[str, torch.Tensor]]:
    """One compressed-gossip subgradient round (diminishing stepsize).
    ``grad_override``: ``(losses, g)`` replacing the (clipped)
    subgradients; on a model axis the clip and the metrics cover each
    agent's whole replica."""
    eng = resolve_engine(engine, mixer, compressor)
    losses, g = _agent_grads(loss_fn, state.x, batch, tau, clip_mode,
                             eng.sharded, grad_override)
    eta_t = _stepsize(eta, state.step)
    x_half = tree_map(lambda x0, gg: x0 - eta_t * gg.to(x0.dtype), state.x, g)
    x, q, m = eng.gossip_apply(gen, x_half, state.q, state.m, gamma,
                               t=state.step)
    return SubgradState(x=x, q=q, m=m, step=state.step + 1), {
        **agent_metrics(losses, [("consensus_x", x)], group=eng.group,
                        sharded=eng.sharded),
        "wire_bytes": _scalar(eng.wire_bytes(state.x), losses)}
