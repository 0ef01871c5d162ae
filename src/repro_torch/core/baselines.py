"""Baseline algorithms the paper compares against (Table 1 and Section 5),
ported from ``src/repro/core/baselines.py``.

* ``dsgd``       decentralized SGD with gossip averaging (no tracking, no
                 EF, optionally clipped or DP) -- the naive adaptation.
* ``choco``      CHOCO-SGD [KSJ19]: compressed gossip with surrogate
                 mirrors, no gradient tracking (``CommRound.gossip_apply``,
                 the ``ef_gossip`` kernel).
* ``dp_sgd``     centralized DP-SGD [ACG+16] -- Table 1's single-server
                 baseline.
* ``soteriafl``  SoteriaFL-SGD [LZLC22]: server/client LDP with *shifted*
                 compression (``CommRound.shift``).

All share the agent-stacked tree layout of :mod:`repro_torch.core.porter`.
Randomness comes from the round's ``torch.Generator`` in a fixed order (DP
noise, then the comm round's draws); the DP steps take ``noise=``, a tree
of N(0, 1) draws shaped like the gradient, in place of their own draw (the
parity tests inject the reference's).  Every DP gradient is
``clipping.dp_gradient``'s: one clip and one mean-plus-noise launch a
chunk of samples.

The server algorithms run with their clients as processes too (one
client a rank of an agent group): SoteriaFL's server mean is one
all-gather of the clients' uploads, DP-SGD's pooled batch one all-gather
of each client's clipped per-sample rows
(:func:`clipping.pooled_dp_gradient`).  The server's state is the same
on every rank, and the one-card run's wherever each client's gradients
are the same bits.

Metrics: ``loss`` (mean agent loss), ``consensus_x`` (decentralized
algorithms) and ``wire_bytes`` (model-level bytes per round), as device
tensors.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..tree import tree_flatten, tree_leaves, tree_map
from . import clipping
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn, apply_mixer, gather_blocks, gossip_wire_bytes
from .porter import LossFn, agent_metrics, replicas

__all__ = [
    "DsgdState", "dsgd_init", "dsgd_step",
    "ChocoState", "choco_init", "choco_step",
    "DpSgdState", "dpsgd_init", "dpsgd_step",
    "SoteriaState", "soteria_init", "soteria_step",
]

Metrics = Dict[str, torch.Tensor]


def _param_count(tree, n_agents: int, sharded=None) -> int:
    """Elements of one agent's replica: every leaf's row, a model-sharded
    leaf's times the model axis under ``sharded`` (a rank holds its
    shard), so the count is the whole replica's."""
    leaves = tree_leaves(tree)
    m = [1] * len(leaves) if sharded is None else sharded.shards()
    return sum(leaf.numel() // n_agents * k for leaf, k in zip(leaves, m))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A device scalar filled in place (no copy from the host)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _agent_grads(loss_fn, x, batch, tau, clip_mode, sharded=None,
                 grad_override=None):
    """Per-agent (losses, gradients), clipped by tau unless it is None;
    across model shards under ``sharded`` (the layout of a model axis).
    ``grad_override``: ``(losses, g)`` returned as given (the clipped
    gradients of a forced round)."""
    if grad_override is not None:
        return grad_override
    g, losses = vmap(grad_and_value(loss_fn))(x, batch)
    if tau is not None:
        g = clipping.stacked_clip(g, tau, clip_mode, sharded)
    return losses, g


# ---------------------------------------------------------------------------
# DSGD
# ---------------------------------------------------------------------------

class DsgdState(NamedTuple):
    x: Any
    step: int


def dsgd_init(params, n_agents: int) -> DsgdState:
    return DsgdState(x=replicas(params, n_agents), step=0)


def dsgd_step(eta: float, gamma: float, loss_fn: LossFn, mixer: MixFn,
              state: DsgdState, batch, gen: Optional[torch.Generator],
              tau: Optional[float] = None, clip_mode: str = "smooth",
              sigma_p: float = 0.0, dp: bool = False, noise: Any = None,
              sharded=None, grad_override=None
              ) -> Tuple[DsgdState, Metrics]:
    """X^{t+1} = X + gamma X(W - I) - eta G   (uncompressed gossip).

    ``sharded``: the per-shard layout on a model axis (dsgd has no
    engine to carry it): the clip across shards, the metrics and the wire
    bytes over the whole replica.  ``grad_override``: ``(losses, g)``
    replacing the gradient oracle."""
    rows = tree_leaves(state.x)[0].shape[0]
    group = getattr(mixer, "group", None)
    n = rows if group is None else group.n_agents * rows
    if grad_override is not None:
        losses, g = grad_override
    elif dp:
        g, losses = clipping.dp_gradient(
            loss_fn, state.x, batch, tau, sigma_p, gen=gen, noise=noise,
            mode=clip_mode, agents="stacked", group=group, sharded=sharded)
    else:
        losses, g = _agent_grads(loss_fn, state.x, batch, tau, clip_mode,
                                 sharded)
    mixed = apply_mixer(mixer, state.x, state.step)
    x = tree_map(lambda x0, wx, gg: x0 + gamma * (wx - x0) - eta * gg,
                 state.x, mixed, g)
    # uncompressed gossip of the full parameter buffer every round
    frac = getattr(mixer, "wire_frac", None)
    wire = gossip_wire_bytes(getattr(mixer, "wire_mode", "dense"), n,
                             _param_count(state.x, rows, sharded),
                             frac=1.0 if frac is None else frac)
    return DsgdState(x=x, step=state.step + 1), {
        **agent_metrics(losses, [("consensus_x", x)], group=group,
                        sharded=sharded),
        "wire_bytes": _scalar(wire, losses)}


# ---------------------------------------------------------------------------
# CHOCO-SGD
# ---------------------------------------------------------------------------

class ChocoState(NamedTuple):
    x: Any
    q: Any      # own surrogate x-hat
    m: Any      # mixing mirror: sum_j w_ij x-hat_j
    step: int


def choco_init(params, n_agents: int, plane_dtype=None) -> ChocoState:
    """``plane_dtype``: storage dtype of the surrogate / mirror buffers
    (bf16 halves them); the params ``x`` keep their own dtype."""
    x = replicas(params, n_agents)
    dt = torch.float32 if plane_dtype is None else plane_dtype
    zeros = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=dt,
                                              device=leaf.device), x)
    return ChocoState(x=x, q=zeros, m=zeros, step=0)


def choco_step(eta: float, gamma: float, loss_fn: LossFn,
               mixer: Optional[MixFn], compressor: Optional[Compressor],
               state: ChocoState, batch, gen: Optional[torch.Generator],
               tau: Optional[float] = None, clip_mode: str = "smooth",
               engine: Optional[CommRound] = None, grad_override=None,
               ) -> Tuple[ChocoState, Metrics]:
    """CHOCO-SGD: x+ = x - eta g;  q += C(x+ - q);  x = x+ + gamma (m - q).
    ``grad_override``: ``(losses, g)`` replacing the gradient oracle."""
    eng = resolve_engine(engine, mixer, compressor)
    losses, g = _agent_grads(loss_fn, state.x, batch, tau, clip_mode,
                             eng.sharded, grad_override)
    x_half = tree_map(lambda x0, gg: x0 - eta * gg, state.x, g)
    x, q, m = eng.gossip_apply(gen, x_half, state.q, state.m, gamma,
                               t=state.step)
    return ChocoState(x=x, q=q, m=m, step=state.step + 1), {
        **agent_metrics(losses, [("consensus_x", x)], group=eng.group,
                        sharded=eng.sharded),
        "wire_bytes": _scalar(eng.wire_bytes(state.x), losses)}


# ---------------------------------------------------------------------------
# Centralized DP-SGD (Table 1 baseline)
# ---------------------------------------------------------------------------

class DpSgdState(NamedTuple):
    x: Any
    step: int


def dpsgd_init(params) -> DpSgdState:
    # copy: the state owns its buffers, apart from the caller's params
    return DpSgdState(x=tree_map(torch.clone, params), step=0)


def dpsgd_step(eta: float, loss_fn: LossFn, state: DpSgdState, batch,
               gen: Optional[torch.Generator], tau: float = 1.0,
               clip_mode: str = "smooth", sigma_p: float = 0.0,
               noise: Any = None, group=None, clipped=None
               ) -> Tuple[DpSgdState, Metrics]:
    """One server step on the pooled batch: x -= eta (mean of the
    per-sample clipped gradients + sigma z).  ``group``: the clients as
    processes, ``batch`` this rank's client's samples, ``x`` the same on
    every rank (:func:`clipping.pooled_dp_gradient`; ``clipped`` forces
    its per-sample oracle)."""
    if group is None:
        if clipped is not None:
            raise ValueError("clipped= forces a rank's rows of the pooled "
                             "batch: it needs the clients' group")
        g, loss = clipping.dp_gradient(loss_fn, state.x, batch, tau,
                                       sigma_p, gen=gen, noise=noise,
                                       mode=clip_mode)
    else:
        g, loss = clipping.pooled_dp_gradient(
            loss_fn, state.x, batch, tau, sigma_p, group, gen=gen,
            noise=noise, mode=clip_mode, clipped=clipped)
    x = tree_map(lambda x0, gg: x0 - eta * gg, state.x, g)
    # one dense gradient upload to the server per round, at each buffer's
    # own dtype width
    wire = sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(state.x))
    return DpSgdState(x=x, step=state.step + 1), {
        "loss": loss, "wire_bytes": _scalar(wire, loss)}


# ---------------------------------------------------------------------------
# SoteriaFL-SGD (server/client, shifted compression)
# ---------------------------------------------------------------------------

class SoteriaState(NamedTuple):
    x: Any       # server model (replicated view)
    h: Any       # per-client shift, agent-stacked
    h_bar: Any   # server-side average shift
    step: int


def soteria_init(params, n_agents: int, plane_dtype=None) -> SoteriaState:
    """``plane_dtype``: storage dtype of the agent-stacked client shifts
    ``h`` (the memory-dominant buffer; bf16 halves it).  The server-side
    ``h_bar`` is a single replica and stays f32."""
    dt = torch.float32 if plane_dtype is None else plane_dtype
    h = tree_map(lambda p: torch.zeros((n_agents,) + tuple(p.shape),
                                       dtype=dt, device=p.device), params)
    h_bar = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return SoteriaState(x=tree_map(torch.clone, params), h=h, h_bar=h_bar,
                        step=0)


def soteria_step(eta: float, alpha_shift: float, loss_fn: LossFn,
                 compressor: Optional[Compressor], state: SoteriaState,
                 batch, gen: Optional[torch.Generator], tau: float = 1.0,
                 clip_mode: str = "smooth", sigma_p: float = 0.0,
                 engine: Optional[CommRound] = None, noise: Any = None,
                 grad_override=None) -> Tuple[SoteriaState, Metrics]:
    """SoteriaFL-SGD: clients send C(g_i - h_i); the server steps with
    h_bar + mean(c).  g_i is each client's per-sample-clipped, perturbed
    gradient at the server model (LDP).  Under the engine's ``clients``
    group (one client a rank) ``h`` and ``batch`` are this rank's client's
    row, the uploads ``c`` (and the clients' losses) are all-gathered in
    one collective and every rank takes the one-card mean, so ``x`` and
    ``h_bar`` stay the same on every rank.  ``grad_override``: ``(losses,
    g)`` replacing the clients' DP gradients."""
    eng = resolve_engine(engine, None, compressor)
    group = eng.group
    if grad_override is None:
        g, losses = clipping.dp_gradient(
            loss_fn, state.x, batch, tau, sigma_p, gen=gen, noise=noise,
            mode=clip_mode, agents="shared", group=group)
    else:
        losses, g = grad_override
    c, h = eng.shift(gen, g, state.h, scale=alpha_shift)
    if group is not None:
        leaves, treedef = tree_flatten(c)
        *full, losses = gather_blocks(group, leaves + [losses])
        c = treedef.unflatten(full)
    c_bar = tree_map(lambda cc: torch.mean(cc, dim=0), c)
    g_tilde = tree_map(torch.add, state.h_bar, c_bar)
    h_bar = tree_map(lambda hb, cb: hb + alpha_shift * cb, state.h_bar, c_bar)
    x = tree_map(lambda x0, gt: (x0 - eta * gt).to(x0.dtype), state.x,
                 g_tilde)
    # n compressed client uploads per round (the server broadcast is not
    # counted, as in the LDP literature's upload accounting)
    return SoteriaState(x=x, h=h, h_bar=h_bar, step=state.step + 1), {
        "loss": torch.mean(losses),
        "wire_bytes": _scalar(eng.wire_bytes(state.h), losses)}
