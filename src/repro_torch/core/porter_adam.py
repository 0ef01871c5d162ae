"""PORTER-Adam: PORTER with an Adam-preconditioned tracked gradient, ported
from ``src/repro/core/porter_adam.py`` (beyond the paper).

Every agent tracks the global gradient in ``v_i`` exactly as PORTER does
(the same two compressed comm rounds), then takes a local Adam step on its
own tracked estimate:

    m_i = b1 m_i + (1 - b1) v_i
    s_i = b2 s_i + (1 - b2) v_i^2
    x_i = x_i + gamma (M_x - Q_x)_i - eta * m-hat_i / (sqrt(s-hat_i) + eps)

The parameter round is ``CommRound.step`` with the preconditioned update as
the descent direction (the ``ef_step`` kernel); the moments are local, never
on the wire, and stay f32 under bf16 planes.  The bias corrections
``1 - b ** (step + 1)`` are f32 scalars formed on the host from the step
(numpy's f32 power; XLA's may differ by an ulp) and filled on the device,
and the divisions by them divide by a device tensor, so no round waits on
the device.  The square root is correctly rounded on every device
(``ref.sqrt_rn`` on the CPU, whose ``torch.sqrt`` can be an ulp low).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ref
from ..tree import tree_leaves, tree_map
from .comm_round import CommRound, resolve_engine
from .compression import Compressor
from .gossip import MixFn
from .porter import (LossFn, PorterConfig, PorterState, _gradients,
                     agent_metrics, porter_init)

__all__ = ["PorterAdamState", "porter_adam_init", "porter_adam_step"]


class PorterAdamState(NamedTuple):
    base: PorterState
    m: Any          # first moment, agent-stacked, f32
    s: Any          # second moment, agent-stacked, f32


def porter_adam_init(params, n_agents: int, w=None,
                     plane_dtype=None, group=None) -> PorterAdamState:
    base = porter_init(params, n_agents, w=w, plane_dtype=plane_dtype,
                       group=group)
    zeros = tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                              device=leaf.device), base.v)
    return PorterAdamState(base=base, m=zeros, s=zeros)


def _sqrt(s: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (CUDA's ``sqrt`` is)."""
    return ref.sqrt_rn(s) if s.device.type == "cpu" else torch.sqrt(s)


def _bias_correction(b: float, step: int, device) -> torch.Tensor:
    """``1 - b ** (step + 1)`` in f32, as a device scalar."""
    value = np.float32(1.0) - np.float32(b) ** np.float32(step + 1)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def porter_adam_step(
    cfg: PorterConfig,
    loss_fn: LossFn,
    mixer: Optional[MixFn],
    compressor: Optional[Compressor],
    state: PorterAdamState,
    batch: Any,
    gen: Optional[torch.Generator],
    b1: float = 0.9,
    b2: float = 0.999,
    adam_eps: float = 1e-8,
    engine: Optional[CommRound] = None,
    noise: Any = None,
    grad_override: Optional[Tuple[torch.Tensor, Any]] = None,
) -> Tuple[PorterAdamState, Dict[str, torch.Tensor]]:
    """One PORTER-Adam round: Algorithm 1 lines 4-12 as ``porter_step``,
    the local moments, then lines 13-14 with the preconditioned update.
    ``gen`` is drawn from in ``porter_step``'s order; ``noise`` stands in
    for the DP draws and ``grad_override`` for the gradient oracle as
    there.  On a model axis (the engine's ``sharded``) the clip and the
    metrics cover each agent's whole replica; the moments are
    elementwise, so a shard's moments are the one-card moments' block."""
    st = state.base
    eng = resolve_engine(engine, mixer, compressor)
    group = eng.group
    if grad_override is None:
        losses, g = _gradients(cfg, loss_fn, st.x, batch, gen, noise, group,
                               eng.sharded)
    else:
        losses, g = grad_override
    g = tree_map(lambda leaf: leaf.to(cfg.grad_dtype), g)

    if eng.overlap:
        # the x-side exchange reads only (x, q_x): both exchanges first
        bits_v = eng.sr_draw(gen, (st.q_v, st.m_v, st.v))
        c_v, wc_v = eng.exchange(gen, st.v, st.q_v, t=st.step)
        bits_x = eng.sr_draw(gen, (st.q_x, st.m_x, st.x))
        c_x, wc_x = eng.exchange(gen, st.x, st.q_x, t=st.step)
        v, q_v, m_v = eng.track_update(c_v, wc_v, st.v, st.q_v, st.m_v, g,
                                       st.g_prev, cfg.gamma, sr_bits=bits_v)
    else:
        v, q_v, m_v = eng.track(gen, st.v, st.q_v, st.m_v, g, st.g_prev,
                                cfg.gamma, t=st.step)

    device = tree_leaves(v)[0].device
    bc1 = _bias_correction(b1, st.step, device)
    bc2 = _bias_correction(b2, st.step, device)
    m = tree_map(lambda m0, vv: b1 * m0 + (1 - b1) * vv, state.m, v)
    s = tree_map(lambda s0, vv: b2 * s0 + (1 - b2) * torch.square(vv),
                 state.s, v)
    update = tree_map(lambda mm, ss: (mm / bc1) / (_sqrt(ss / bc2)
                                                    + adam_eps), m, s)

    if eng.overlap:
        x, q_x, m_x = eng.step_update(c_x, wc_x, st.x, st.q_x, st.m_x,
                                      update, cfg.gamma, cfg.eta,
                                      sr_bits=bits_x)
    else:
        x, q_x, m_x = eng.step(gen, st.x, st.q_x, st.m_x, update,
                               cfg.gamma, cfg.eta, t=st.step)

    base = PorterState(x=x, v=v, q_x=q_x, q_v=q_v, g_prev=g, m_x=m_x,
                       m_v=m_v, step=st.step + 1)
    metrics = {
        **agent_metrics(losses, [("consensus_x", x), ("consensus_v", v)],
                        group=group, sharded=eng.sharded),
        "wire_bytes": torch.full((), 2.0 * eng.wire_bytes(st.x),
                                 dtype=torch.float32, device=losses.device),
    }
    return PorterAdamState(base=base, m=m, s=s), metrics
