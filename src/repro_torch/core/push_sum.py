"""DP-CSGP: differentially private compressed gossip over directed graphs,
ported from ``src/repro/core/push_sum.py`` (beyond the paper).

PORTER-DP's recipe over a column-stochastic ``W_t`` with push-sum
de-biasing:

* every agent carries a push-sum weight ``xw_i`` (1 at the start), mixed
  with the same ``W_t`` as the params; column sums of 1 keep the total
  ``1^T xw = n``, and the gradients are taken at the de-biased
  ``z = x / xw``, not at ``x``;
* the weight runs the params' EF recursion (surrogate ``q_w``, mirror
  ``m_w``) with an increment that is never compressed, and the three
  ``(n,)`` weight planes stay f32 under bf16 planes: the recursion
  composes to ``xw' = ((1 - gamma) I + gamma W_t) xw``, column-stochastic,
  so the weights stay positive.

The x-side round is ``CommRound.step_ps`` (the ``ef_step`` kernel for the
params, three f32 AXPYs for the weights); the v-side round is PORTER's
``track``.  On a doubly stochastic ``W`` the weight increments are 0, ``xw``
stays exactly 1, ``x / 1`` is ``x``, and the round is bitwise PORTER-DP's
(with ``m_x`` made by the same mix at init: ``porter_init(w=W)``).

On a grid with a model axis (the engine's ``sharded`` layout) every rank
holds its agent's shard of each buffer and the whole ``(n,)`` weight
planes' row: the weights are replicated on an agent's M ranks and each
model index's ranks run the same weight recursion on the same values, so
they stay bitwise equal across them; the debias divides each shard by its
agent's weight, the clip and the DP noise cross the shards as PORTER-DP's
do, and a codec executor carries the weight words in each shard's last
buffer, as the one-card codec carries them in its own.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn
from .porter import (LossFn, PorterConfig, _gradients, agent_metrics,
                     mixed_replicas, replicas)

__all__ = ["DpCsgpState", "dp_csgp_init", "dp_csgp_step", "debias"]

# guards the de-biasing division against underflow on very long windows;
# exact arithmetic keeps every weight positive
_WEIGHT_FLOOR = 1e-12


class DpCsgpState(NamedTuple):
    x: Any
    v: Any
    q_x: Any
    q_v: Any
    g_prev: Any
    m_x: Any
    m_v: Any
    xw: torch.Tensor     # (n,) push-sum weights, f32
    q_w: torch.Tensor    # (n,) their surrogate
    m_w: torch.Tensor    # (n,) their mixing mirror
    step: int


def debias(x, xw):
    """``z = x / xw``, the (n,) weight broadcast over each leaf's agent
    axis; with ``xw`` exactly 1 this is ``x`` bitwise."""
    w = torch.clamp(xw.to(torch.float32), min=_WEIGHT_FLOOR)
    return tree_map(lambda leaf: (leaf / w.reshape(
        (-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)).to(leaf.dtype), x)


def dp_csgp_init(params: Any, n_agents: int, w: Optional[np.ndarray] = None,
                 w0: Optional[np.ndarray] = None,
                 buffer_dtype: Any = torch.float32,
                 plane_dtype: Any = None, group=None) -> DpCsgpState:
    """X^0 = x0 1^T, weights 1.  The mirrors are made with the round-0
    matrix (``w`` if given, else ``w0``: the facade passes the schedule's
    first table or the topology's W): ``m_x = W x``, ``m_w = W 1``, since a
    column-stochastic W has no row-sum shortcut.  With neither, ``m_x = x``
    and ``m_w = 1``.  The param EF buffers take ``plane_dtype``; the weight
    planes stay f32.  ``group``: an agent group, one agent a rank: the
    state holds this rank's row (``n_agents`` 1)."""
    x = replicas(params, n_agents)
    device = tree_leaves(x)[0].device
    zero_dtype = buffer_dtype if plane_dtype is None else plane_dtype
    zeros = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=zero_dtype,
                                              device=leaf.device), x)
    ones = torch.ones((n_agents,), dtype=torch.float32, device=device)
    weff = w if w is not None else w0
    if weff is None:
        m_x, m_w = x, ones
    else:
        weff = np.asarray(weff, np.float64)
        if weff.ndim == 3:
            weff = weff[0]
        m_x = mixed_replicas(params, weff, group)
        m_w = torch.as_tensor(weff.sum(axis=1), dtype=torch.float32).to(device)
        if group is not None:
            m_w = group.rows(m_w)
    q_x = x
    if plane_dtype is not None:
        q_x = tree_map(lambda leaf: leaf.to(plane_dtype), x)
        m_x = tree_map(lambda leaf: leaf.to(plane_dtype), m_x)
    return DpCsgpState(x=x, v=zeros, q_x=q_x, q_v=zeros, g_prev=zeros,
                       m_x=m_x, m_v=zeros, xw=ones, q_w=ones, m_w=m_w,
                       step=0)


def dp_csgp_step(
    cfg: PorterConfig,
    loss_fn: LossFn,
    mixer: Optional[MixFn],
    compressor: Optional[Compressor],
    state: DpCsgpState,
    batch: Any,
    gen: Optional[torch.Generator],
    engine: Optional[CommRound] = None,
    noise: Any = None,
    grad_override: Optional[Tuple[torch.Tensor, Any]] = None,
) -> Tuple[DpCsgpState, Dict[str, torch.Tensor]]:
    """One DP-CSGP round: PORTER-DP's, with the gradients at ``z = x / xw``,
    the x-side round :meth:`CommRound.step_ps`, and the weight's bytes on
    the x stream.  ``gen`` is drawn from in ``porter_step``'s order;
    ``noise`` stands in for the DP draws; ``grad_override``: optional
    ``(losses, g)`` replacing the gradient oracle, as ``porter_step``'s."""
    eng = resolve_engine(engine, mixer, compressor)
    group = eng.group
    if grad_override is None:
        losses, g = _gradients(cfg, loss_fn, debias(state.x, state.xw),
                               batch, gen, noise, group, eng.sharded)
    else:
        losses, g = grad_override
    g = tree_map(lambda leaf: leaf.to(cfg.grad_dtype), g)

    if eng.overlap:
        bits_v = eng.sr_draw(gen, (state.q_v, state.m_v, state.v))
        c_v, wc_v = eng.exchange(gen, state.v, state.q_v, t=state.step)
        bits_x = eng.sr_draw(gen, (state.q_x, state.m_x, state.x))
        c_x, wc_x, cw, wcw = eng.exchange_ps(
            gen, state.x, state.q_x, state.xw, state.q_w, t=state.step)
        v, q_v, m_v = eng.track_update(c_v, wc_v, state.v, state.q_v,
                                       state.m_v, g, state.g_prev, cfg.gamma,
                                       sr_bits=bits_v)
        x, q_x, m_x, xw, q_w, m_w = eng.step_ps_update(
            c_x, wc_x, cw, wcw, state.x, state.q_x, state.m_x, v,
            state.xw, state.q_w, state.m_w, cfg.gamma, cfg.eta,
            sr_bits=bits_x)
    else:
        v, q_v, m_v = eng.track(gen, state.v, state.q_v, state.m_v, g,
                                state.g_prev, cfg.gamma, t=state.step)
        x, q_x, m_x, xw, q_w, m_w = eng.step_ps(
            gen, state.x, state.q_x, state.m_x, v, state.xw, state.q_w,
            state.m_w, cfg.gamma, cfg.eta, t=state.step)

    new_state = DpCsgpState(x=x, v=v, q_x=q_x, q_v=q_v, g_prev=g, m_x=m_x,
                            m_v=m_v, xw=xw, q_w=q_w, m_w=m_w,
                            step=state.step + 1)
    wire = eng.wire_bytes(state.x) + eng.wire_bytes(state.x, push_sum=True)
    metrics = {
        # consensus on the de-biased estimates: x drifting toward the
        # Perron vector is push-sum at work, not disagreement
        **agent_metrics(losses, [("consensus_x", debias(x, xw)),
                                 ("consensus_v", v)], [("v_norm", v)],
                        group, eng.sharded),
        "wire_bytes": torch.full((), wire, dtype=torch.float32,
                                 device=losses.device),
    }
    return new_state, metrics
