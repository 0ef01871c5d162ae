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
rows; piecewise and none stay eager on one card (the reference has no
kernel for them).

Per-sample clipped mini-batch gradients (:func:`clipped_grad_accumulate`,
the mean alone; :func:`dp_gradient`, the mean plus ``sigma * z``, the DP
gradient) take the local batch in chunks of c samples.  The reference
scans one sample at a time, so its peak is one sample's gradient an agent
plus one f32 accumulator.  Here each chunk takes the gradients of its c
samples for every agent with ``torch.func.vmap``
(:func:`per_sample_grads`), packs them into one ``(n * c * T, TILE)``
plane, clips it in one launch outside the vmap, where a kernel can
launch, and adds it onto the running sum in one ``ops.dp_mean_noise``
call (the ``mean_noise`` kernel); the last chunk's call multiplies by
``RN(1 / b)`` and adds the noise, drawn once in the mean's shape before
it.  The samples are added in the same order onto the same +0.0 as in
one call over the whole batch, so the chunked mean is bitwise the
unchunked one wherever each sample's gradient is the same bits in a vmap
of c samples as of b (the products take one agent's rows only: see
:func:`per_sample_grads`).  :func:`sample_chunk` picks c from the bytes
of the per-sample plane (:data:`SAMPLE_PLANE_BYTES`): every chunk's plane
is one budget's worth or less, or one sample's when that alone is more.
Every sample mean, of the gradients and of the losses, is the reference's
jitted one (``ref.sample_mean``: in sample order onto +0.0, then the
product with ``RN(1 / b)``), on the CPU and on the card alike.

The cross-shard clip (``sharded``, a :class:`repro_torch.kernels.flatten.
ShardedFlatSpec`: an agent's replica split over the model axis): Definition
2's norm is the whole agent's (or sample's) gradient's, and a rank's plane
holds its shards only.  So the clip is ``ops.clip_sumsq`` (the ``sumsq``
kernel) over the rank's plane, with the replicated leaves counted on model
rank 0 only (zeroed for the pass elsewhere, then restored); each row's
partials summed in the fused kernel's fixed order (``ref.row_sumsq``); one
all-reduce of the ``(rows,)`` sums over ``'model'``
(:func:`cross_shard_sumsq`, which Clip21's residual norm takes too); the
factors (``ref.sumsq_factors`` for the smooth mode, :func:`clip_factor` of
the correctly rounded root for piecewise and none); and
``ops.clip_scale`` (the ``scale`` kernel), in every mode, as the
reference's ``tree_clip`` over a model-sharded tree takes the global norm
whatever the mode.  The DP path takes it for every chunk's per-sample
rows, then
``mean_noise`` on the rank's shard with its slice of the one-card noise.

DP-SGD with its clients as processes (:func:`pooled_dp_gradient`): each
rank clips its own client's per-sample rows, the rows are all-gathered in
rank order (the one-card pool's order) and every rank adds them onto one
running sum: every rank's mean is the one-card mean wherever each
clipped row is the same bits.
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import torch
from torch.func import grad_and_value, vmap

from ..kernels import flatten as FL
from ..kernels import ops, ref
from .agents import local_rows, model_shard
from ..tree import tree_flatten, tree_leaves, tree_map

__all__ = ["smooth_clip", "piecewise_clip", "tree_global_norm", "tree_clip",
           "clip_factor", "stacked_clip", "cross_shard_sumsq",
           "cross_shard_clip",
           "SAMPLE_PLANE_BYTES", "sample_chunk", "per_sample_grads",
           "clipped_grad_accumulate", "dp_gradient", "pooled_dp_gradient"]

ClipMode = Literal["smooth", "piecewise", "none"]

# The per-sample plane of one chunk of samples, n * c * T * TILE elements,
# stays within this many bytes (or holds one sample when that is more).
# In f32, 4 * 26,754 * 8,192 * 4 B = 3.51 GB a sample for tinyllama-1.1b's
# full width at 2 of 22 layers over 4 agents: c = 1.  PORTER-DP on the
# Section-5.2 MLP, 10 agents * 7 tiles * 8 samples, is 18.4 MB, and on the
# fleet, 4,096 agents * 1 tile * 4 samples, 537 MB: c = b, one chunk.
SAMPLE_PLANE_BYTES = 4 << 30


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


def cross_shard_sumsq(planes, spec: FL.FlatSpec, sharded) -> torch.Tensor:
    """Each row's sum of squares over its whole replica, from a rank's
    ``(rows * T, TILE)`` plane of model shards (layout ``spec``):
    ``sumsq`` with the replicated leaves counted on model rank 0 only
    (zeroed for the pass elsewhere, then restored), the rows' partials
    summed in the fused kernel's fixed order, one all-reduce over
    ``'model'`` -> ``(rows,)`` f32, the same on every model rank."""
    group = sharded.group
    hidden = []
    if group.model_index != 0:
        view = planes.view(max(spec.rows, 1), spec.padded)
        for (lo, hi), dim in zip(FL.leaf_ranges(spec), sharded.dims()):
            if dim is None:
                hidden.append((lo, hi, view[:, lo:hi].clone()))
                view[:, lo:hi] = 0
    partials = ops.clip_sumsq(planes)
    for lo, hi, kept in hidden:
        view[:, lo:hi] = kept
    rows = max(spec.rows, 1)
    return group.all_reduce_sum(ref.row_sumsq(partials, rows), axis="model")


def cross_shard_clip(planes, spec: FL.FlatSpec, tau: float, sharded,
                     mode: ClipMode = "smooth"):
    """Definition 2 (or Remark 1, or no clip, by ``mode``) over a rank's
    plane of model shards, each row by the norm of its whole replica: the
    sums of :func:`cross_shard_sumsq`, the factors (the smooth mode's
    ``ref.sumsq_factors``, else :func:`clip_factor` of their correctly
    rounded roots), ``scale``.  Returns (the clipped plane, the
    ``(rows,)`` factors)."""
    sums = cross_shard_sumsq(planes, spec, sharded)
    if mode == "smooth":
        factors = ref.sumsq_factors(sums, tau)
    else:
        factors = clip_factor(ref.sqrt_rn(sums), tau, mode)
    return ops.clip_scale(planes, factors), factors


def _clip_plane(planes, spec: FL.FlatSpec, tau: float, mode: ClipMode,
                sharded):
    """The clipped plane: the fused ``clip`` (smooth, one card) or
    :func:`cross_shard_clip` (any mode, under ``sharded``)."""
    if sharded is None:
        return ops.clip_planes(planes, max(spec.rows, 1), tau)[0]
    return cross_shard_clip(planes, spec, tau, sharded, mode)[0]


def stacked_clip(tree, tau: float, mode: ClipMode = "smooth", sharded=None):
    """Clip each row of a row-stacked tree by the norm of that row over
    all leaves: ``tree_clip`` of every row.  Smooth clipping packs the
    rows into one flat plane and clips it in ``ops.clip_planes`` (the
    per-tile sums of squares, one factor a row, the scale: one launch on
    the card); under ``sharded`` every mode packs the rows and clips
    across model shards in :func:`cross_shard_clip`, as the reference's
    ``tree_clip`` over a model-sharded tree takes the whole norm; each
    leaf comes back in its own dtype."""
    if mode != "smooth" and sharded is None:
        return vmap(lambda t: tree_clip(t, tau, mode))(tree)
    spec = FL.flat_spec(tree)
    return FL.from_planes(
        _clip_plane(FL.to_planes(tree, spec), spec, tau, mode, sharded),
        spec)


def _clipped_plane(rows, tau: float, mode: ClipMode, sharded=None):
    """Each row of a row-stacked tree clipped by its own norm, in the rows'
    plane: the smooth mode through ``ops.clip_planes``, every mode through
    :func:`cross_shard_clip` under ``sharded``, piecewise and none on one
    card eagerly, then packed.  Returns (the plane, its layout)."""
    spec = FL.flat_spec(rows)
    if mode == "smooth" or sharded is not None:
        return _clip_plane(FL.to_planes(rows, spec), spec, tau, mode,
                           sharded), spec
    return FL.to_planes(stacked_clip(rows, tau, mode), spec), spec


def _add_chunk(planes, spec, b: int, stacked: bool, sigma: float = 0.0,
               noise=None, acc=None, finish: bool = True, b_total=None):
    """Add each group's b clipped rows of ``planes`` (group g's sample s is
    row ``g * b + s`` of ``spec``) onto the f32 running sum ``acc`` (or
    +0.0) in one ``ops.dp_mean_noise`` call; with ``finish``, the sum times
    ``RN(1 / b_total)`` plus ``sigma`` times ``noise(mean_spec, device)``
    (a tree shaped like the mean) when ``noise`` is given.  Returns (the
    f32 plane, the mean's layout: with the leading group axis when
    ``stacked``)."""
    groups = spec.rows // b
    mean = spec._replace(rows=groups if stacked else 0,
                         plane_dtype=torch.float32)
    z = (None if noise is None
         else FL.to_planes(noise(mean, planes.device), mean))
    return ops.dp_mean_noise(planes, groups, b, z, sigma, acc=acc,
                             finish=finish, b_total=b_total), mean


def sample_chunk(groups: int, tiles: int, b: int, itemsize: int = 4,
                 budget: Optional[int] = None) -> int:
    """The samples a chunk takes: the largest c <= b whose per-sample
    plane, ``groups * c * tiles * TILE * itemsize`` bytes, stays within
    ``budget`` (:data:`SAMPLE_PLANE_BYTES` when None), and at least 1."""
    budget = SAMPLE_PLANE_BYTES if budget is None else budget
    one = groups * tiles * FL.TILE * itemsize
    return max(1, min(b, budget // one))


def _sample_axis(agents: Optional[str]) -> int:
    if agents not in (None, "stacked", "shared"):
        raise ValueError(f"agents must be None, 'stacked' or 'shared', got "
                         f"{agents!r}")
    return 0 if agents is None else 1


def per_sample_grads(loss_fn: Callable, params, batch, agents: Optional[str]):
    """Every sample's gradient and loss: (the row-stacked gradients, one
    row a sample, agent-major; the losses, ``(b,)`` or ``(agents, b)``).

    ``"shared"`` params are expanded along the agent axis (a view) and
    differentiated as ``"stacked"`` ones: every agent's products then take
    its own rows only, never one product over all agents' rows, whose row
    count (and with it a BLAS's summation order) would change with the
    number of samples."""
    _sample_axis(agents)

    def one(p, sample):
        sample = tree_map(lambda a: a.unsqueeze(0), sample)
        return grad_and_value(loss_fn)(p, sample)

    per_sample = vmap(one, in_dims=(None, 0))
    if agents == "shared":
        n = tree_leaves(batch)[0].shape[0]
        params = tree_map(lambda a: a.unsqueeze(0).expand(
            (n,) + tuple(a.shape)), params)
    if agents is not None:
        per_sample = vmap(per_sample)
    gs, losses = per_sample(params, batch)
    lead = losses.dim()
    rows = tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[lead:])), gs)
    return rows, losses


def _noise(gen: Optional[torch.Generator], noise, group=None, sharded=None):
    """``z_of(mean, device)``: ``noise``, or z ~ N(0, 1) from ``gen`` leaf
    by leaf in tree order, in the mean's shape and each leaf's dtype;
    under an agent ``group`` this rank's rows of the one-card draw (or of
    ``noise``, given at the one-card shape), under ``sharded`` its model
    shard's block of them."""

    def z_of(mean, device):
        dims = ([None] * len(mean.shapes) if sharded is None
                else sharded.dims())
        if noise is not None:
            if group is None:
                return noise
            leaves, treedef = tree_flatten(noise)
            return treedef.unflatten([model_shard(
                group.rows(z), d, getattr(group, "model_index", 0),
                getattr(group, "model_size", 1))
                for z, d in zip(leaves, dims)])
        lead = (mean.rows,) if mean.rows else ()
        return mean.treedef.unflatten([
            local_rows(group, lead + shape, lambda full, dt=dt: torch.randn(
                full, generator=gen, dtype=dt, device=device), dim)
            for shape, dt, dim in zip(mean.shapes, mean.dtypes, dims)])

    return z_of


def _chunked_mean(loss_fn: Callable, params, batch, tau: float,
                  mode: ClipMode, agents: Optional[str], sigma: float,
                  gen: Optional[torch.Generator], noise, dp: bool,
                  chunk: Optional[int], group=None, sharded=None):
    """The per-sample clipped mean over the local batch in chunks of
    ``chunk`` samples (:func:`sample_chunk`'s when None), plus ``sigma *
    z`` when ``dp``: z is ``noise`` (a tree shaped like the mean) or drawn
    from ``gen`` leaf by leaf in tree order before the last chunk's mean.
    Returns ``(mean, mean_loss)``."""
    axis = _sample_axis(agents)
    b = tree_leaves(batch)[0].shape[axis]
    if chunk is None:
        p = tree_leaves(params)
        per_row = sum(leaf.numel() for leaf in p) // (
            p[0].shape[0] if agents == "stacked" else 1)
        groups = 1 if agents is None else tree_leaves(batch)[0].shape[0]
        chunk = sample_chunk(groups, -(-per_row // FL.TILE), b,
                             FL.derived_plane_dtype(params).itemsize)
    if chunk < 1:
        raise ValueError(f"sample_chunk must be at least 1, got {chunk}")

    z_of = _noise(gen, noise, group, sharded)
    acc, losses = None, []
    for lo in range(0, b, chunk):
        size = min(chunk, b - lo)
        part = tree_map(lambda a: a.narrow(axis, lo, size), batch)
        rows, loss = per_sample_grads(loss_fn, params, part, agents)
        losses.append(loss)
        planes, spec = _clipped_plane(rows, tau, mode, sharded)
        del rows        # before the sum, and the next chunk's gradients
        finish = lo + size == b
        acc, mean = _add_chunk(planes, spec, size, agents is not None, sigma,
                               z_of if finish and dp else None, acc, finish,
                               b)
        del planes
    losses = losses[0] if len(losses) == 1 else torch.cat(losses, -1)
    return FL.from_planes(acc, mean), ref.sample_mean(losses, losses.dim() - 1)


def clipped_grad_accumulate(loss_fn: Callable, params, batch, tau: float,
                            mode: ClipMode = "smooth",
                            agents: Optional[str] = None,
                            sample_chunk: Optional[int] = None):
    """Mean of per-sample clipped gradients: (1/b) sum_z Clip_tau(grad l(x; z)).

    PORTER-DP line 6 without its noise.  ``batch`` is a tree whose leaves
    have a leading local-batch axis b (after the agent axis, when there is
    one); each sample keeps a singleton batch dimension, as loss functions
    are written for batched inputs.  ``agents``: None for one model
    (DP-SGD); ``"stacked"`` when the params and the batch carry a leading
    agent axis (PORTER-DP, DSGD); ``"shared"`` when only the batch does and
    every agent differentiates the same params (SoteriaFL's clients).  The
    samples go in chunks of ``sample_chunk`` (:func:`sample_chunk`'s from
    the plane's bytes when None), each chunk's per-sample gradients of all
    agents clipped in one plane and added onto the running sum.  Returns
    ``(mean_clipped_grad, mean_loss)``, with a leading agent axis unless
    ``agents`` is None.
    """
    return _chunked_mean(loss_fn, params, batch, tau, mode, agents, 0.0,
                         None, None, False, sample_chunk)


def dp_gradient(loss_fn: Callable, params, batch, tau: float, sigma: float,
                gen: Optional[torch.Generator] = None, noise=None,
                mode: ClipMode = "smooth", agents: Optional[str] = None,
                sample_chunk: Optional[int] = None, group=None,
                sharded=None):
    """The DP gradient of PORTER-DP line 6 and the DP baselines: the mean
    of the per-sample clipped gradients plus ``sigma * z``, z ~ N(0, 1)
    drawn from ``gen`` leaf by leaf in tree order, in each leaf's shape
    and dtype (or given as ``noise``, a tree shaped like the mean).
    ``batch``, ``agents`` and ``sample_chunk`` as in
    :func:`clipped_grad_accumulate`; the noise is drawn once, before the
    last chunk's mean.  ``group``: an agent group, the params and batch
    this rank's agent row (``agents="stacked"``); z is then this rank's
    rows of the one-card draw.  ``sharded``: the model axis's layout; each
    chunk is clipped across shards (:func:`cross_shard_clip`) and z is the
    rank's block of the one-card draw (or of ``noise``).  Returns
    ``(perturbed_mean, mean_loss)``."""
    return _chunked_mean(loss_fn, params, batch, tau, mode, agents, sigma,
                         gen, noise, True, sample_chunk, group, sharded)


def pooled_dp_gradient(loss_fn: Callable, params, batch, tau: float,
                       sigma: float, group,
                       gen: Optional[torch.Generator] = None, noise=None,
                       mode: ClipMode = "smooth", chunk: Optional[int] = None,
                       clipped=None):
    """DP-SGD's pooled gradient with its clients as processes: the
    :func:`dp_gradient` of the server's pooled batch (``agents=None``) when
    ``batch`` is this rank's b samples and ``params`` the server's replica,
    the same on every rank of ``group``.

    Each rank differentiates and clips only its own samples (one clip a
    chunk, on its plane of per-sample rows).  The clipped rows are
    all-gathered in rank order, which is the one-card pool's agent-major
    order, and every rank adds them onto one running sum in that order
    (``mean_noise`` a chunk), so the sum is the one-card sum wherever each
    sample's clipped row is the same bits.  z is drawn at the server's
    shape from ``gen`` on every rank (or is ``noise``), and the loss is the
    mean over all the samples' losses, gathered with the rows.  When every
    rank's b rows fit :data:`SAMPLE_PLANE_BYTES` together (c = b,
    :func:`sample_chunk` over the ranks' planes, or ``chunk``), one gather
    takes them all; else rank after rank, c of its samples a gather, the
    other ranks sending zeros of the same shape.  ``clipped``: ``(plane,
    losses)``, this rank's clipped ``(b * T, TILE)`` plane and its ``(b,)``
    losses in place of the per-sample oracle (a forced round).  Returns
    ``(perturbed_mean, mean_loss)``, the same on every rank."""
    b = tree_leaves(batch)[0].shape[0]
    ranks, me = group.n_agents, group.index
    one = FL.flat_spec(tree_map(lambda p: p.unsqueeze(0), params))
    tiles = one.tiles
    c = (sample_chunk(ranks, tiles, b, one.plane_dtype.itemsize)
         if chunk is None else chunk)
    if c < 1:
        raise ValueError(f"sample_chunk must be at least 1, got {c}")
    # (the rank whose samples [lo, hi) a gather takes, None: every rank's)
    pieces = ([(None, 0, b)] if c >= b else
              [(p, lo, min(lo + c, b)) for p in range(ranks)
               for lo in range(0, b, c)])
    total = ranks * b
    z_of = _noise(gen, noise)
    acc, losses, done = None, [], 0
    for owner, lo, hi in pieces:
        size = hi - lo
        if owner not in (None, me):
            plane = torch.zeros((size * tiles, FL.TILE), dtype=one.plane_dtype,
                                device=tree_leaves(params)[0].device)
            loss = plane.new_zeros((size,), dtype=torch.float32)
        elif clipped is not None:
            plane, loss = clipped[0][lo * tiles:hi * tiles], clipped[1][lo:hi]
        else:
            part = tree_map(lambda x: x.narrow(0, lo, size), batch)
            rows, loss = per_sample_grads(loss_fn, params, part, None)
            plane = _clipped_plane(rows, tau, mode)[0]
            del rows
        # the losses cross in f32: exact, and the mean adds in f32
        planes, sample_losses = group.all_gather([plane,
                                                  loss.to(torch.float32)])
        del plane
        if owner is None:
            size = total
            planes = planes.reshape(-1, FL.TILE)
            sample_losses = sample_losses.reshape(-1)
        else:
            planes, sample_losses = planes[owner], sample_losses[owner]
        losses.append(sample_losses)
        done += size
        finish = done == total
        acc, mean = _add_chunk(planes, one._replace(rows=size), size, False,
                               sigma, z_of if finish else None, acc, finish,
                               total)
        del planes
    losses = losses[0] if len(losses) == 1 else torch.cat(losses)
    return FL.from_planes(acc, mean), ref.sample_mean(losses, 0)
