"""Clip21-style error-feedback clipping, decentralized: ported from
``src/repro/core/clip21.py`` (beyond the paper).

Clip21 clips the *residual* of the gradient against a per-agent running
estimate instead of the gradient itself (EF21 with Clip as the
compressor):

    delta_i = g_i - hat g_i;   hat g_i += Clip_tau(delta_i)

Once the iterates settle, ``||delta|| < tau`` and the estimate locks onto
the gradient.  ``hat g`` replaces PORTER's gradient oracle: the step takes
the unclipped gradients, updates the estimates, and hands
``(losses, hat g)`` to ``porter_step(grad_override=...)``, whose comm
rounds are PORTER's.  The residual clip is piecewise (``min(1, tau /
||delta||)``; the smooth factor never reaches 1) and eager: the reference
runs it in jnp and has no kernel for it.  On a model axis the residual's
norm is the whole replica's, from ``clipping.cross_shard_sumsq`` (one
``sumsq`` over the rank's plane of shards and one all-reduce over
``'model'``), as the reference's norm of a model-sharded tree.  Where the
factor is 1 the estimate is the raw gradient bitwise, so at ``tau = inf``
the round is bitwise porter-gc's with a piecewise clip at ``tau = inf``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels import flatten as FL
from ..kernels import ref
from ..tree import tree_leaves, tree_map
from . import clipping
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn
from .porter import (PorterConfig, PorterState, _gradients, agent_metrics,
                     porter_init, porter_step)

__all__ = ["Clip21State", "clip21_update", "clip21_init", "clip21_step"]


class Clip21State(NamedTuple):
    base: PorterState   # PORTER's buffers, with the round counter
    g_est: Any          # hat g: each agent's gradient estimate, f32


def _agent_norms(tree, sharded=None) -> torch.Tensor:
    """Each agent's l2 norm over all leaves of a stacked tree, the root
    correctly rounded as ``clipping.tree_global_norm``'s.  Under
    ``sharded`` (a model axis) the norm of the agent's whole replica: the
    sums of ``clipping.cross_shard_sumsq`` over the rank's plane of
    shards (the replicated leaves counted once, one all-reduce over
    ``'model'``), then the root."""
    if sharded is not None:
        spec = FL.flat_spec(tree)
        return ref.sqrt_rn(clipping.cross_shard_sumsq(
            FL.to_planes(tree, spec), spec, sharded))
    n = tree_leaves(tree)[0].shape[0]
    return ref.sqrt_rn(sum(
        torch.sum(torch.square(leaf.to(torch.float32)).reshape(n, -1), dim=1)
        for leaf in tree_leaves(tree)))


def clip21_update(g_est: Any, g_raw: Any, tau: float, sharded=None) -> Any:
    """Every agent's ``g_est + Clip_tau(g_raw - g_est)``, piecewise, by the
    agent's norm over all leaves (of its whole replica under ``sharded``).
    Where the factor is 1 the result is ``g_raw`` itself, bitwise (``a +
    1.0 * (b - a)`` need not be b)."""
    delta = tree_map(lambda a, b: a - b, g_raw, g_est)
    factor = clipping.clip_factor(_agent_norms(delta, sharded), tau,
                                  "piecewise")

    def one(ge, gr, d):
        f = factor.reshape((-1,) + (1,) * (d.dim() - 1))
        return torch.where(f >= 1.0, gr, (ge + f * d).to(gr.dtype))

    return tree_map(one, g_est, g_raw, delta)


def clip21_init(params: Any, n_agents: int, w=None,
                buffer_dtype: Any = torch.float32,
                plane_dtype: Any = None, group=None) -> Clip21State:
    """hat g = 0 (the first round clips the whole gradient); PORTER's
    buffers start as porter-gc's."""
    base = porter_init(params, n_agents, w=w, buffer_dtype=buffer_dtype,
                       plane_dtype=plane_dtype, group=group)
    g_est = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                              device=leaf.device), base.x)
    return Clip21State(base=base, g_est=g_est)


def clip21_step(
    cfg: PorterConfig,
    loss_fn,
    mixer: Optional[MixFn],
    compressor: Optional[Compressor],
    state: Clip21State,
    batch: Any,
    gen: Optional[torch.Generator],
    engine: Optional[CommRound] = None,
    grad_override: Optional[Tuple[torch.Tensor, Any]] = None,
) -> Tuple[Clip21State, Dict[str, torch.Tensor]]:
    """One Clip21 round: the unclipped gradients, the EF-clipped estimate,
    PORTER's comm rounds.  ``cfg.tau`` is the residual's threshold; the
    round draws from ``gen`` as porter-gc's does.  ``grad_override``:
    ``(losses, g_raw)`` replacing the unclipped gradients.  On a model
    axis (the engine's ``sharded``) the residual's norm and the metrics
    cover each agent's whole replica."""
    eng = resolve_engine(engine, mixer, compressor)
    if grad_override is None:
        raw_cfg = dataclasses.replace(cfg, variant="beer")
        losses, g_raw = _gradients(raw_cfg, loss_fn, state.base.x, batch,
                                   gen, None)
    else:
        losses, g_raw = grad_override
    g_est = clip21_update(state.g_est, g_raw, cfg.tau, eng.sharded)
    base, metrics = porter_step(cfg, loss_fn, None, None, state.base,
                                batch, gen, engine=eng,
                                grad_override=(losses, g_est))
    resid = tree_map(lambda a, b: a - b, g_raw, g_est)
    metrics.update(agent_metrics(norms=[("clip_residual", resid)],
                                 group=eng.group, sharded=eng.sharded))
    return Clip21State(base=base, g_est=g_est), metrics
