"""Gradient clipping operators (paper Definition 2 and Remark 1).

* ``smooth_clip``     Clip_tau(x) = tau / (tau + ||x||) * x      (Definition 2)
* ``piecewise_clip``  Clip_tau(x) = x * min(1, tau/||x||)        (Remark 1)

Tree versions clip by the global norm across all leaves.  Per-sample
clipped mini-batch gradients for PORTER-DP come from
:func:`clipped_grad_accumulate`, which takes per-sample gradients with
``torch.func.vmap`` (the reference scans one sample at a time).
"""

from __future__ import annotations

from typing import Callable, Literal

import torch
from torch.func import grad_and_value, vmap

from ..tree import tree_leaves, tree_map

__all__ = ["smooth_clip", "piecewise_clip", "tree_global_norm", "tree_clip",
           "clip_factor", "clipped_grad_accumulate"]

ClipMode = Literal["smooth", "piecewise", "none"]


def smooth_clip(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Definition 2 on a single tensor (norm over the whole tensor)."""
    return (tau / (tau + torch.linalg.vector_norm(x))) * x


def piecewise_clip(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Remark 1 on a single tensor."""
    nrm = torch.linalg.vector_norm(x)
    return x * torch.clamp(tau / torch.clamp(nrm, min=1e-30), max=1.0)


def tree_global_norm(tree) -> torch.Tensor:
    """l2 norm of the concatenation of all leaves."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_factor(norm: torch.Tensor, tau: float, mode: ClipMode) -> torch.Tensor:
    if mode == "smooth":
        return tau / (tau + norm)
    if mode == "piecewise":
        return torch.clamp(tau / torch.clamp(norm, min=1e-30), max=1.0)
    if mode == "none":
        return torch.ones_like(norm)
    raise ValueError(f"unknown clip mode {mode!r}")


def tree_clip(tree, tau: float, mode: ClipMode = "smooth"):
    """Clip a tree by its global l2 norm."""
    c = clip_factor(tree_global_norm(tree), tau, mode)
    return tree_map(lambda leaf: (leaf * c).to(leaf.dtype), tree)


def clipped_grad_accumulate(loss_fn: Callable, params, batch, tau: float,
                            mode: ClipMode = "smooth"):
    """Mean of per-sample clipped gradients: (1/b) sum_z Clip_tau(grad l(x; z)).

    PORTER-DP line 6.  ``batch`` is a tree whose leaves have a leading
    local-batch axis b; each sample keeps a singleton batch dimension, as
    loss functions are written for batched inputs.  Returns
    ``(mean_clipped_grad, mean_loss)``.
    """
    b = tree_leaves(batch)[0].shape[0]

    def one(sample):
        sample = tree_map(lambda a: a.unsqueeze(0), sample)
        g, loss = grad_and_value(loss_fn)(params, sample)
        return tree_clip(g, tau, mode), loss

    gs, losses = vmap(one)(batch)
    return tree_map(lambda a: a.sum(0) / b, gs), losses.sum() / b
