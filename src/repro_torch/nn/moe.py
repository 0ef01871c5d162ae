"""Feed-forward blocks (``src/repro/nn/moe.py``): gated and plain MLPs, and
Mixture-of-Experts with the reference's capacity dispatch.

MoE, as the reference computes it in jnp (no Pallas kernel): an f32 router
and softmax, the top-k experts of each token (ties to the lower expert, as
``jax.lax.top_k``: a stable descending sort here), gates renormalised,
each (token, choice) given the slot of the count of earlier choices of its
expert (an exclusive cumsum of the one-hot), choices past the capacity
``max(ceil(capacity_factor * T * k / E), 1)`` sent to an overflow row that
is thrown away, one batched product per expert weight over the (E, C, d)
buffers, and the gate-weighted sum of each token's k outputs.  The
Switch-style load-balance loss comes back beside the output; arctic adds a
dense MLP in parallel (``dense_residual``).  The kept slots are unique, so
the one scatter into the buffers (``scatter``) writes each at most
once; the overflow row may take many writes, in any order.  The scatter
and the expert one-hots (a comparison with ``arange(E)``) are functional,
so ``torch.func.vmap`` batches the layer under ``grad`` without a
per-sample loop.  The
reference's sharding specs are dropped (one card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .module import dense, init_dense, param

__all__ = ["MlpConfig", "init_mlp", "mlp", "MoeConfig", "init_moe", "moe",
           "top_k_stable"]


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"   # 'silu' (gated), 'gelu' (gated), 'relu2', 'gelu_plain'


def _act(name: str, x):
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return torch.square(torch.relu(x))
    raise ValueError(name)


def init_mlp(gen: torch.Generator, cfg: MlpConfig, lead=()):
    gated = cfg.activation in ("silu", "gelu")
    p = {"w_in": init_dense(gen, cfg.d_model, cfg.d_ff, lead=lead),
         "w_out": init_dense(gen, cfg.d_ff, cfg.d_model, lead=lead)}
    if gated:
        p["w_gate"] = init_dense(gen, cfg.d_model, cfg.d_ff, lead=lead)
    return p


def mlp(p, cfg: MlpConfig, x):
    if "w_gate" in p:
        h = _act(cfg.activation, dense(p["w_gate"], x)) * dense(p["w_in"], x)
    else:
        act = "gelu" if cfg.activation == "gelu_plain" else cfg.activation
        h = _act(act, dense(p["w_in"], x))
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    activation: str = "silu"
    dense_residual: bool = False      # arctic: parallel dense MLP
    dense_d_ff: Optional[int] = None  # hidden of the residual MLP
    expert_parallel_threshold: int = 16


def init_moe(gen: torch.Generator, cfg: MoeConfig, lead=()):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": init_dense(gen, d, e, scale=scale, lead=lead),
        "w_gate": param(gen, (*lead, e, d, f), scale),
        "w_in": param(gen, (*lead, e, d, f), scale),
        "w_out": param(gen, (*lead, e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.dense_residual:
        p["dense_mlp"] = init_mlp(
            gen, MlpConfig(d, cfg.dense_d_ff or f, cfg.activation), lead=lead)
    return p


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest of each row and their indices, largest first, equal
    values in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p, cfg: MoeConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss); the module docstring has the
    dispatch."""
    b, s, d = x.shape
    n_tok = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(math.ceil(cfg.capacity_factor * n_tok * k / e)), 1)

    xt = x.reshape(n_tok, d)
    logits = dense(p["router"], xt.to(torch.float32))          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_stable(probs, k)               # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # capacity slots: the count of earlier choices of the same expert
    flat_expert = gate_idx.reshape(-1)                          # (T*k,)
    # a comparison, not one_hot: one_hot checks its range on the data,
    # which torch.func.vmap refuses
    experts = torch.arange(e, dtype=flat_expert.dtype, device=x.device)
    onehot = (flat_expert[:, None] == experts).to(flat_expert.dtype)
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = slot < cap
    dest = torch.where(keep, flat_expert * cap + slot, e * cap)

    # dispatch: one scatter into (E*C + 1, d), the last row the overflow
    buf = xt.new_zeros((e * cap + 1, d)).scatter(
        0, dest[:, None].expand(-1, d), xt.repeat_interleave(k, dim=0))
    buf = buf[: e * cap].reshape(e, cap, d)

    # expert compute, batched over E
    gate_h = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    in_h = torch.bmm(buf, p["w_in"].to(buf.dtype))
    h = _act(cfg.activation, gate_h) * in_h
    out_buf = torch.bmm(h, p["w_out"].to(buf.dtype))

    # combine: gather back, weight, sum over the k choices
    out_flat = out_buf.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(dest, max=e * cap - 1)], 0.0)
    weighted = (gathered.reshape(n_tok, k, d)
                * gate_vals[..., None].to(x.dtype))
    out = weighted.sum(dim=1).reshape(b, s, d)

    # Switch load-balance aux loss
    me = probs.mean(dim=0)                                       # (E,)
    ce = (gate_idx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    if "dense_mlp" in p:
        dcfg = MlpConfig(cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                         cfg.activation)
        out = out + mlp(p["dense_mlp"], dcfg, x)
    return out, aux
