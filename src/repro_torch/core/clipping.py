"""Gradient clipping operators (paper Definition 2 and Remark 1).

* ``smooth_clip``     Clip_tau(x) = tau / (tau + ||x||) * x      (Definition 2)
* ``piecewise_clip``  Clip_tau(x) = x * min(1, tau/||x||)        (Remark 1)

Tree versions clip by the global norm across all leaves.  Every factor is
the correctly rounded f32 quotient that the reference (XLA) gives: the
dividend is a tensor, because PyTorch computes ``float / tensor`` as
``tensor.reciprocal() * float``, one f32 ulp away in about a quarter of
cases at tau = 0.3 (exact only when tau is a power of two).

The algorithms clip many trees at once: :func:`stacked_clip` takes a
row-stacked tree (each leaf's leading axis one agent, or one sample) and
clips each row by its own norm over all its leaves.  The smooth mode runs
on the flat tile planes of :mod:`repro_torch.kernels.flatten` through the
fused ``clip`` kernel (``kernels/ops.clip_planes``), one launch for all
rows; piecewise and none stay eager (the reference has no kernel for
them).  Per-sample clipped mini-batch gradients take the per-sample
gradients with ``torch.func.vmap`` (:func:`per_sample_grads`; the
reference scans one sample at a time) and clip them all in one plane
outside the vmap, where a kernel can launch; each group's sample mean,
plus the DP noise when there is one, is formed from that plane in one
``ops.dp_mean_noise`` call (the ``mean_noise`` kernel), with no tree
between the clip and the mean (:func:`clip_mean_noise`).
:func:`clipped_grad_accumulate` gives the mean alone, :func:`dp_gradient`
the mean plus ``sigma * z``, the DP gradient.  Every sample mean, of the
gradients and of the losses, is the reference's jitted one
(``ref.sample_mean``: in sample order onto +0.0, then the product with
``RN(1 / b)``), on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import torch
from torch.func import grad_and_value, vmap

from ..kernels import flatten as FL
from ..kernels import ops, ref
from ..tree import tree_leaves, tree_map

__all__ = ["smooth_clip", "piecewise_clip", "tree_global_norm", "tree_clip",
           "clip_factor", "stacked_clip", "clip_mean_noise",
           "per_sample_grads", "clipped_grad_accumulate", "dp_gradient"]

ClipMode = Literal["smooth", "piecewise", "none"]


def _quotient(tau: float, den: torch.Tensor) -> torch.Tensor:
    """``tau / den``, correctly rounded (a tensor dividend)."""
    return torch.full_like(den, tau) / den


def smooth_clip(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Definition 2 on a single tensor (norm over the whole tensor)."""
    return _quotient(tau, tau + torch.linalg.vector_norm(x)) * x


def piecewise_clip(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Remark 1 on a single tensor."""
    nrm = torch.linalg.vector_norm(x)
    return x * torch.clamp(_quotient(tau, torch.clamp(nrm, min=1e-30)),
                           max=1.0)


def tree_global_norm(tree) -> torch.Tensor:
    """l2 norm of the concatenation of all leaves."""
    return ref.sqrt_rn(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                           for leaf in tree_leaves(tree)))


def clip_factor(norm: torch.Tensor, tau: float, mode: ClipMode) -> torch.Tensor:
    if mode == "smooth":
        return _quotient(tau, tau + norm)
    if mode == "piecewise":
        return torch.clamp(_quotient(tau, torch.clamp(norm, min=1e-30)),
                           max=1.0)
    if mode == "none":
        return torch.ones_like(norm)
    raise ValueError(f"unknown clip mode {mode!r}")


def tree_clip(tree, tau: float, mode: ClipMode = "smooth"):
    """Clip a tree by its global l2 norm."""
    c = clip_factor(tree_global_norm(tree), tau, mode)
    return tree_map(lambda leaf: (leaf * c).to(leaf.dtype), tree)


def stacked_clip(tree, tau: float, mode: ClipMode = "smooth"):
    """Clip each row of a row-stacked tree by the norm of that row over
    all leaves: ``tree_clip`` of every row.  Smooth clipping packs the
    rows into one flat plane and clips it in ``ops.clip_planes`` (the
    per-tile sums of squares, one factor a row, the scale: one launch on
    the card); each leaf comes back in its own dtype."""
    if mode != "smooth":
        return vmap(lambda t: tree_clip(t, tau, mode))(tree)
    spec = FL.flat_spec(tree)
    return FL.from_planes(
        ops.clip_planes(FL.to_planes(tree, spec), spec.rows, tau)[0], spec)


def clip_mean_noise(rows, b: int, tau: float, sigma: float = 0.0,
                    noise=None, mode: ClipMode = "smooth",
                    stacked: bool = True):
    """Clip each of the ``groups * b`` rows of a row-stacked tree (group
    g's sample s is row ``g * b + s``) by its own norm, then give each
    group's sample mean, plus ``sigma * noise`` when ``noise`` is given (a
    tree shaped like the mean).  The mean has the leading group axis when
    ``stacked``, else it is one group's without it.  The smooth mode clips
    the rows' plane in ``ops.clip_planes`` and hands it straight to
    ``ops.dp_mean_noise``; piecewise and none clip eagerly and pack the
    rows for the same call.  Each leaf comes back in its own dtype."""
    spec = FL.flat_spec(rows)
    if mode == "smooth":
        planes = ops.clip_planes(FL.to_planes(rows, spec), spec.rows, tau)[0]
    else:
        planes = FL.to_planes(stacked_clip(rows, tau, mode), spec)
    groups = spec.rows // b
    mean = spec._replace(rows=groups if stacked else 0,
                         plane_dtype=torch.float32)
    z = None if noise is None else FL.to_planes(noise, mean)
    return FL.from_planes(ops.dp_mean_noise(planes, groups, b, z, sigma),
                          mean)


def per_sample_grads(loss_fn: Callable, params, batch, agents: Optional[str]):
    """Every sample's gradient and loss: (the row-stacked gradients, one
    row a sample, agent-major; the losses, ``(b,)`` or ``(agents, b)``)."""
    if agents not in (None, "stacked", "shared"):
        raise ValueError(f"agents must be None, 'stacked' or 'shared', got "
                         f"{agents!r}")

    def one(p, sample):
        sample = tree_map(lambda a: a.unsqueeze(0), sample)
        return grad_and_value(loss_fn)(p, sample)

    per_sample = vmap(one, in_dims=(None, 0))
    if agents == "stacked":
        per_sample = vmap(per_sample)
    elif agents == "shared":
        per_sample = vmap(per_sample, in_dims=(None, 0))
    gs, losses = per_sample(params, batch)
    lead = losses.dim()
    rows = tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[lead:])), gs)
    return rows, losses


def clipped_grad_accumulate(loss_fn: Callable, params, batch, tau: float,
                            mode: ClipMode = "smooth",
                            agents: Optional[str] = None):
    """Mean of per-sample clipped gradients: (1/b) sum_z Clip_tau(grad l(x; z)).

    PORTER-DP line 6 without its noise.  ``batch`` is a tree whose leaves
    have a leading local-batch axis b (after the agent axis, when there is
    one); each sample keeps a singleton batch dimension, as loss functions
    are written for batched inputs.  ``agents``: None for one model
    (DP-SGD); ``"stacked"`` when the params and the batch carry a leading
    agent axis (PORTER-DP, DSGD); ``"shared"`` when only the batch does and
    every agent differentiates the same params (SoteriaFL's clients).  The
    per-sample gradients of all agents are clipped and averaged in
    :func:`clip_mean_noise`.  Returns ``(mean_clipped_grad, mean_loss)``,
    with a leading agent axis unless ``agents`` is None.
    """
    rows, losses = per_sample_grads(loss_fn, params, batch, agents)
    g = clip_mean_noise(rows, losses.shape[-1], tau, mode=mode,
                        stacked=agents is not None)
    return g, ref.sample_mean(losses, losses.dim() - 1)


def dp_gradient(loss_fn: Callable, params, batch, tau: float, sigma: float,
                gen: Optional[torch.Generator] = None, noise=None,
                mode: ClipMode = "smooth", agents: Optional[str] = None):
    """The DP gradient of PORTER-DP line 6 and the DP baselines: the mean
    of the per-sample clipped gradients plus ``sigma * z``, z ~ N(0, 1)
    drawn from ``gen`` leaf by leaf in tree order, in each leaf's shape
    and dtype (or given as ``noise``, a tree shaped like the mean).
    ``batch`` and ``agents`` as in :func:`clipped_grad_accumulate`; the
    clip, the mean and the noise run in :func:`clip_mean_noise`.  Returns
    ``(perturbed_mean, mean_loss)``."""
    rows, losses = per_sample_grads(loss_fn, params, batch, agents)
    lead = tuple(losses.shape)
    if noise is None:
        noise = tree_map(lambda a: torch.randn(
            lead[:-1] + tuple(a.shape[1:]), generator=gen, dtype=a.dtype,
            device=a.device), rows)
    g = clip_mean_noise(rows, lead[-1], tau, sigma, noise, mode,
                        stacked=agents is not None)
    return g, ref.sample_mean(losses, len(lead) - 1)
