"""Feed-forward blocks (``src/repro/nn/moe.py``); this slice ports the gated
and plain MLPs.  Mixture-of-Experts waits for the decoder slice (ROADMAP
queue 1 item 13)."""

from __future__ import annotations

import dataclasses

import torch

from .module import dense, init_dense

__all__ = ["MlpConfig", "init_mlp", "mlp"]


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
