"""PORTER (paper Algorithm 1): decentralized nonconvex optimization with
gradient clipping and communication compression.

Every buffer is an agent-stacked tree: each leaf carries a leading
``n_agents`` axis.  Buffers (paper notation): ``x`` parameters, ``v``
gradient-tracking estimates, ``q_x`` / ``q_v`` compressed surrogates,
``g_prev`` the previous clipped (and perturbed) gradient, ``m_x`` / ``m_v``
the mixing mirrors ``W q``.  One iteration (lines 4-14):

    G^t   = clipped/perturbed stochastic gradient at X^{t-1}     (DP or GC)
    c_v   = C(V^{t-1} - Q_v^{t-1});  Q_v += c_v;  M_v += W c_v   (comm)
    V^t   = V^{t-1} + gamma (M_v - Q_v) + G^t - G^{t-1}
    c_x   = C(X^{t-1} - Q_x^{t-1});  Q_x += c_x;  M_x += W c_x   (comm)
    X^t   = X^{t-1} + gamma (M_x - Q_x) - eta V^t

Lines 11-14 belong to the comm-round engine (:class:`CommRound`); this
module owns the gradient oracle and the metrics.  Gradients come from
``torch.func.grad_and_value`` under ``torch.func.vmap`` over the agent axis;
the clip and the DP noise run after the vmap, over all agents at once
(:mod:`repro_torch.core.clipping`; DP: ``clipping.dp_gradient``, one clip
and one mean-plus-noise launch a chunk of samples, one chunk a round
unless the per-sample plane passes its budget).
Nothing is updated in place, so ``porter_init`` may alias buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..kernels import ref
from ..tree import tree_flatten, tree_leaves, tree_map
from . import clipping
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn, make_dense_mixer

__all__ = ["PorterConfig", "PorterState", "porter_init", "porter_step",
           "average_params", "consensus_error", "agent_metrics"]

LossFn = Callable[[Any, Any], torch.Tensor]  # (params, batch) -> scalar


@dataclasses.dataclass(frozen=True)
class PorterConfig:
    """Hyper-parameters of Algorithm 1.

    variant: 'dp' (clip-then-batch + Gaussian noise, Option I),
             'gc' (batch-then-clip, Option II),
             'beer' (no clipping -- the BEER ancestor, tau ignored).
    """

    eta: float
    gamma: float
    tau: float = 1.0
    variant: str = "gc"
    clip_mode: str = "smooth"
    sigma_p: float = 0.0
    grad_dtype: Any = torch.float32

    def __post_init__(self):
        if self.variant not in ("dp", "gc", "beer"):
            raise ValueError(f"unknown variant {self.variant!r}")


class PorterState(NamedTuple):
    x: Any
    v: Any
    q_x: Any
    q_v: Any
    g_prev: Any
    m_x: Any
    m_v: Any
    step: int  # absolute round index (W_t selector once schedules land)


def replicas(params: Any, n_agents: int):
    """``n_agents`` stacked copies of one replica (X = x0 1^T)."""
    return tree_map(lambda p: p.unsqueeze(0).expand(
        (n_agents,) + tuple(p.shape)).clone(), params)


def mixed_replicas(params: Any, w, group=None):
    """``W X`` for X = x0 1^T: the mirror a column-stochastic W needs at
    init; under an agent ``group`` this rank's row of the one-card
    product (all n replicas are made for it, once)."""
    n = np.asarray(w).shape[-1]
    out = make_dense_mixer(w)(replicas(params, n))
    return out if group is None else tree_map(group.rows, out)


def porter_init(params: Any, n_agents: int, w: Optional[np.ndarray] = None,
                buffer_dtype: Any = torch.float32,
                plane_dtype: Any = None, group=None) -> PorterState:
    """Initialize from one replica on its device: X^0 = x0 1^T (line 2).

    ``plane_dtype``: storage dtype of the six EF buffers (q_x, q_v, m_x,
    m_v, v, g_prev); bf16 halves the resident state while the master
    params ``x`` keep their own dtype.  None keeps the f32 layout:
    surrogates in x's dtype, zeros in ``buffer_dtype``.  ``group``: an
    agent group, one agent a rank: the state holds this rank's row
    (``n_agents`` is then 1; ``w`` mixes all n replicas).
    """
    x = replicas(params, n_agents)
    zero_dtype = buffer_dtype if plane_dtype is None else plane_dtype
    zeros = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=zero_dtype,
                                              device=leaf.device), x)
    # all agents are equal and rows of W sum to 1, so W X0 = X0
    m_x = x if w is None else mixed_replicas(params, w, group)
    q_x = x
    if plane_dtype is not None:
        q_x = tree_map(lambda leaf: leaf.to(plane_dtype), x)
        m_x = tree_map(lambda leaf: leaf.to(plane_dtype), m_x)
    return PorterState(x=x, v=zeros, q_x=q_x, q_v=zeros, g_prev=zeros,
                       m_x=m_x, m_v=zeros, step=0)


def _gradients(cfg: PorterConfig, loss_fn: LossFn, x, batch, gen, noise,
               group=None, sharded=None):
    """Per-agent losses and clipped (and, for DP, perturbed) gradients
    (lines 5-10).  Every agent's (or every sample's) gradient is clipped in
    one row-stacked call, outside the vmap; across model shards under
    ``sharded`` (the engine's layout on a model axis)."""
    if cfg.variant == "dp":
        # Option I: clip each sample's gradient, average, perturb
        g, losses = clipping.dp_gradient(
            loss_fn, x, batch, cfg.tau, cfg.sigma_p, gen=gen, noise=noise,
            mode=cfg.clip_mode, agents="stacked", group=group,
            sharded=sharded)
        return losses, g
    # Option II / BEER: one batch gradient, clipped after (or not at all)
    g, losses = vmap(grad_and_value(loss_fn))(x, batch)
    if cfg.variant == "gc":
        g = clipping.stacked_clip(g, cfg.tau, cfg.clip_mode, sharded)
    return losses, g


def porter_step(
    cfg: PorterConfig,
    loss_fn: LossFn,
    mixer: Optional[MixFn],
    compressor: Optional[Compressor],
    state: PorterState,
    batch: Any,
    gen: Optional[torch.Generator],
    engine: Optional[CommRound] = None,
    grad_override: Optional[Tuple[torch.Tensor, Any]] = None,
    noise: Any = None,
) -> Tuple[PorterState, Dict[str, torch.Tensor]]:
    """One PORTER iteration over all agents.

    batch: tree with leaves (n_agents, b, ...).  gen: the round's generator;
    it is drawn from in a fixed order (DP noise, then the v-side and the
    x-side rounds, each its SR words under bf16 planes and then its
    compressor) in both the sequential and the overlap order.
    grad_override: optional ``(losses, g)`` replacing the gradient oracle.
    noise: optional tree shaped like the gradient, standing in for the
    N(0, 1) draws of the DP perturbation (the parity tests inject the
    reference's draws here).
    """
    eng = resolve_engine(engine, mixer, compressor)
    group = eng.group

    # ---- stochastic gradients (local; lines 4-10) -------------------------
    if grad_override is None:
        losses, g = _gradients(cfg, loss_fn, state.x, batch, gen, noise,
                               group, eng.sharded)
    else:
        losses, g = grad_override
    g = tree_map(lambda leaf: leaf.to(cfg.grad_dtype), g)

    # ---- comm rounds: track (lines 11-12) + step (lines 13-14) ------------
    if eng.overlap:
        # the x-side exchange reads only (x, q_x), which the v-side update
        # never touches: both exchanges go first, same values, same draws
        # (each round's SR words, then its compressor's, as track/step do)
        bits_v = eng.sr_draw(gen, (state.q_v, state.m_v, state.v))
        c_v, wc_v = eng.exchange(gen, state.v, state.q_v, t=state.step)
        bits_x = eng.sr_draw(gen, (state.q_x, state.m_x, state.x))
        c_x, wc_x = eng.exchange(gen, state.x, state.q_x, t=state.step)
        v, q_v, m_v = eng.track_update(c_v, wc_v, state.v, state.q_v,
                                       state.m_v, g, state.g_prev, cfg.gamma,
                                       sr_bits=bits_v)
        x, q_x, m_x = eng.step_update(c_x, wc_x, state.x, state.q_x,
                                      state.m_x, v, cfg.gamma, cfg.eta,
                                      sr_bits=bits_x)
    else:
        v, q_v, m_v = eng.track(gen, state.v, state.q_v, state.m_v, g,
                                state.g_prev, cfg.gamma, t=state.step)
        x, q_x, m_x = eng.step(gen, state.x, state.q_x, state.m_x, v,
                               cfg.gamma, cfg.eta, t=state.step)

    new_state = PorterState(x=x, v=v, q_x=q_x, q_v=q_v, g_prev=g,
                            m_x=m_x, m_v=m_v, step=state.step + 1)
    device = losses.device
    metrics = {
        **agent_metrics(losses, [("consensus_x", x), ("consensus_v", v)],
                        [("v_norm", v)], group, eng.sharded),
        # two compressed streams (Q_x and Q_v) per round; a fill, not a copy
        # from the host, so the step never waits on the device
        "wire_bytes": torch.full((), 2.0 * eng.wire_bytes(state.x),
                                 dtype=torch.float32, device=device),
    }
    return new_state, metrics


# Cross-agent reductions.  Under an agent group (a block of agent rows a
# rank: one, or a fleet's n / ranks) each
# reduces over the group, so every rank reports the value of the whole
# agent axis: the loss mean bitwise the one-card one (the per-agent losses
# cross exactly), the sums over agents up to their order.  ``step``
# functions take their metrics from ``agent_metrics``: two all-reduces a
# round, whatever the metrics; on a model axis a third, of the sums over
# the shards (each replicated leaf counted once).


def average_params(x_stacked, group=None):
    """x-bar: the average replica (the paper's evaluation point)."""
    if group is None:
        return tree_map(lambda leaf: torch.mean(leaf, dim=0), x_stacked)
    return tree_map(lambda bar, leaf: bar.to(leaf.dtype),
                    _agent_bar(x_stacked, group), x_stacked)


def _row_sum(leaf: torch.Tensor) -> torch.Tensor:
    """The sum of a rank's agent rows, flat (one row as it is)."""
    return (leaf if leaf.shape[0] == 1 else leaf.sum(0)).reshape(-1)


def _agent_bar(tree, group):
    """Every f32 leaf's mean over all agents, from one all-reduce of the
    sums of this rank's rows."""
    leaves = [leaf.to(torch.float32) for leaf in tree_leaves(tree)]
    total = group.all_reduce_sum(torch.cat([_row_sum(leaf)
                                            for leaf in leaves]))
    bars, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        bars.append(total[off:off + size].reshape(leaf.shape[1:])
                    / (group.n_agents * leaf.shape[0]))
        off += size
    return tree_flatten(tree)[1].unflatten(bars)


def agent_metrics(losses: Optional[torch.Tensor] = None, consensus=(),
                  norms=(), group=None, sharded=None
                  ) -> Dict[str, torch.Tensor]:
    """A round's cross-agent metrics: ``loss`` (the mean of the per-agent
    ``losses``, when given), each ``(name, tree)`` of ``consensus`` as
    :func:`consensus_error` and each of ``norms`` as ``||Y||_F / sqrt(n)``,
    in that order.

    Under a group (each rank a block of k agent rows: one, or a fleet's
    n / ranks) they take two all-reduces: one of the sums of every
    consensus tree's rows, every rank's k losses in their own slots of an
    ``(n,)`` vector (``v + 0`` is exact, so the mean is the one-card
    ``torch.mean``) and every norm's sum of squares; then one of the
    deviations from the means.  Under ``sharded`` (a model axis) the
    rank's trees are its shards, the replicated leaves counted on model
    rank 0 only, and a third all-reduce, over ``'model'``, sums the
    deviations and the norms' sums over the shards, so every rank reports
    the whole replica's value.
    """
    out = {}
    if group is None:
        if losses is not None:
            out["loss"] = torch.mean(losses)
        for name, tree in consensus:
            out[name] = consensus_error(tree)
        for name, tree in norms:
            n = tree_leaves(tree)[0].shape[0]
            out[name] = clipping.tree_global_norm(tree) / math.sqrt(n)
        return out
    keep = None if sharded is None else sharded.counted()

    def kept(tree):
        leaves = tree_leaves(tree)
        return [leaf.to(torch.float32) for i, leaf in enumerate(leaves)
                if keep is None or keep[i]]

    rows = [kept(tree) for _, tree in consensus]
    trees = [tree for _, tree in (*consensus, *norms)]
    k = (losses.numel() if losses is not None
         else tree_leaves(trees[0])[0].shape[0] if trees else 1)
    n = group.n_agents * k
    parts = [_row_sum(leaf) for leaves in rows for leaf in leaves]
    if losses is not None:
        slots = torch.zeros(n, dtype=losses.dtype, device=losses.device)
        slots[group.index * k:(group.index + 1) * k] = losses.reshape(k)
        parts.append(slots.to(torch.float32))
    for _, tree in norms:
        parts.append(sum(torch.sum(torch.square(leaf))
                         for leaf in kept(tree)).reshape(1))
    total = group.all_reduce_sum(torch.cat(parts))
    devs, off = [], 0
    for leaves in rows:
        dev = 0.0
        for leaf in leaves:
            size = leaf[0].numel()
            bar = total[off:off + size].reshape(leaf.shape[1:]) / n
            dev = dev + torch.sum(torch.square(leaf - bar))
            off += size
        devs.append(dev.reshape(1))
    if losses is not None:
        out["loss"] = torch.mean(total[off:off + n].to(losses.dtype))
        off += n
    dev_total = group.all_reduce_sum(torch.cat(devs)) if devs else total[:0]
    norm_sums = total[off:off + len(norms)]
    if sharded is not None:
        # the sums over the agents, summed over the model shards too
        whole = group.all_reduce_sum(torch.cat([dev_total, norm_sums]),
                                     axis="model")
        dev_total, norm_sums = whole[:len(devs)], whole[len(devs):]
    for i, (name, _) in enumerate(consensus):
        out[name] = dev_total[i]
    for j, (name, _) in enumerate(norms):
        out[name] = ref.sqrt_rn(norm_sums[j]) / math.sqrt(n)
    return out


def consensus_error(tree, group=None) -> torch.Tensor:
    """|| Y - y_bar 1^T ||_F^2 across all leaves (all agents')."""
    if group is not None:
        return agent_metrics(consensus=[("c", tree)], group=group)["c"]

    def leaf_err(leaf):
        lf = leaf.to(torch.float32)
        return torch.sum(torch.square(lf - lf.mean(dim=0, keepdim=True)))

    return sum(leaf_err(leaf) for leaf in tree_leaves(tree))
