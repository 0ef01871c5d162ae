"""Tensor parallelism over the model axis of an agent grid.

The reference trains every agent's replica tensor-parallel over its mesh's
``'model'`` axis: its leaves carry PartitionSpecs
(:func:`repro_torch.nn.module.leaf_specs`) and XLA's partitioner inserts
the collectives.  Here an agent's ``M`` model ranks
(:class:`repro_torch.launch.mesh.AgentGroup` with ``model_size = M``) each
hold their shard of every sharded leaf, the replicated leaves whole, and
the forward says where the collectives go, as Megatron-LM does:

* :func:`copy_to_model` -- identity forward, all-reduce backward: in
  front of a column-parallel layer, whose input is replicated, so the
  input's gradient sums every shard's part;
* :func:`reduce_from_model` -- all-reduce forward, identity backward:
  behind a row-parallel layer, whose output is a partial sum;
* :func:`max_from_model` -- the max over the shards, with no gradient;
* :func:`gather_from_model` -- all-gather forward along one dimension,
  this rank's slice of the gradient backward: the gathered tensor is
  replicated, so its gradient is whole on every rank.  Where each rank
  reads the gathered tensor differently (its own heads of a kv head split
  over the ranks) :func:`copy_to_model` goes after it, and the backward
  is then an all-reduce followed by this rank's slice;
* :func:`slice_for_model` -- this rank's slice of a replicated tensor, in
  front of a row-parallel layer whose input is not already split;
* :func:`split_norm` -- a norm over a last axis that is split across the
  ranks (rwkv6's and Mamba2's ``out_norm`` over heads split by rank): the
  slices gathered, normalised replicated, this rank's slice kept, so the
  statistics' gradient reaches every rank's channels;
* :func:`gather_packed` -- a model-sharded leaf whole at use (Mamba2's
  ``w_in``, whose one sharded dimension packs fields of different widths
  that the reference's contiguous blocks cut across): the all-gather,
  then :func:`copy_to_model`, so the backward sums every rank's partial
  gradient and keeps this rank's block.

Every rank then computes the same replicated activations and the same
loss, and its gradient of its own shard is the shard of the one-card
gradient (the replicated leaves' gradients whole on every rank).  The
collectives are ``torch.autograd.Function`` s with ``setup_context`` and a
``vmap`` rule (one collective on the batched tensor, batched on dim 0), so
the per-agent ``vmap(grad_and_value(loss))`` of the algorithms and the
per-sample one of DP run through them.  Each sums in f32 and casts back.

The layers: :func:`column_dense` / :func:`row_dense`, the vocab-parallel
:func:`embedding` and :func:`cross_entropy_loss` (f32: the max over shards,
detached; the sum of exponentials and the gold logit, each all-reduced;
then ``lse - gold``), the d_model-sharded :func:`embedding_columns` (the
reference's layout of a vocab that :data:`repro_torch.models.model.
MODEL_AXIS_SIZE` does not divide: this rank's columns looked up, then
gathered) and :func:`local_heads` (how the specs split the attention
heads).  :func:`check_shardable` refuses a leaf whose sharded dimension
the model axis does not divide; nothing is padded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.agents import model_shard
from .module import dense

__all__ = ["copy_to_model", "reduce_from_model", "max_from_model",
           "gather_from_model", "slice_for_model", "split_norm",
           "gather_packed", "column_dense",
           "row_dense", "embedding", "embedding_columns",
           "cross_entropy_loss", "check_shardable", "Heads", "local_heads",
           "shard_hook"]

_F32 = torch.float32


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return group.all_reduce_sum(x.to(_F32), axis="model").to(x.dtype)


def _vmap_rule(fn):
    """The ``vmap`` staticmethod of a collective: the batched tensor's
    batch axis moved to 0, one collective over it, batched on 0 out."""
    def rule(info, in_dims, x, *rest):
        bdim = in_dims[0]
        if bdim is None:
            return fn.apply(x, *rest), None
        return fn.apply(x.movedim(bdim, 0), *rest), 0
    return staticmethod(rule)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return group.all_gather([x.contiguous()], axis="model")[0].amax(0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        parts = group.all_gather([x.contiguous()], axis="model")[0]
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.dim = inputs
        ctx.width = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.model_index * ctx.width,
                         ctx.width), None, None)


for _fn in (_Copy, _Reduce, _Max, _Gather):
    _fn.vmap = _vmap_rule(_fn)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model axis."""
    return _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model axis (in f32, cast back); identity
    gradient."""
    return _Reduce.apply(x, group)


def max_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the model axis, without a gradient."""
    return _Max.apply(x.detach(), group)


def gather_from_model(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    """Every model rank's ``x`` joined along ``dim`` in rank order (one
    all-gather); the gradient is this rank's slice of the output's, which
    is whole on every rank (the module docstring says when to follow it
    with :func:`copy_to_model`)."""
    return _Gather.apply(x, group, dim - x.dim() if dim >= 0 else dim)


def slice_for_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's ``1 / M`` slice of the replicated ``x`` along ``dim``:
    the input of a row-parallel layer.  Its gradient is all-reduced
    (:func:`copy_to_model`), since each rank's covers its slice only."""
    width = x.shape[dim] // group.model_size
    return copy_to_model(x, group).narrow(dim, group.model_index * width,
                                          width)


def split_norm(norm, p, x: torch.Tensor, group) -> torch.Tensor:
    """``norm(p, x)`` over a last axis split across the model ranks in
    rank order (``x`` this rank's slice, ``p`` whole on every rank): the
    slices gathered, ``norm`` applied replicated, this rank's slice of the
    result kept.  The slice's backward all-reduces, so the gradient of the
    normalised tensor is whole on every rank, the norm's parameters get
    their whole gradient everywhere, and the gather's backward hands each
    rank the part of its own channels (mean and variance included)."""
    return slice_for_model(norm(p, gather_from_model(x, group, -1)), group,
                           -1)


def gather_packed(w: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """A model-sharded leaf whole on every rank, for a layer that reads
    other columns than its own block: every rank's block joined along
    ``dim``, then :func:`copy_to_model`.  Each rank's gradient of the whole
    leaf covers what it read; the backward sums them over the model axis
    and keeps this rank's block."""
    return copy_to_model(gather_from_model(w, group, dim), group)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def column_dense(p, x: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` with ``w`` (and its bias) split by output columns: this
    rank's columns of the output."""
    return dense(p, copy_to_model(x, group))


def row_dense(p, x: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` with ``w`` split by input rows and ``x`` by its last
    axis alike: the partial products summed over the model axis, then the
    (replicated) bias."""
    y = reduce_from_model(x @ p["w"].to(x.dtype), group)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


class Heads(NamedTuple):
    """How a rank's attention reads the heads: ``q`` whole q heads (``m q
    ...``), attending with ``kv`` kv heads; ``gathered``: the kv head
    columns are split below a head (``n_kv_heads % M != 0``), so k and v
    are gathered over the model axis and the rank keeps kv head
    ``kv_head``, the one its q heads share."""
    q: int
    kv: int
    gathered: bool = False
    kv_head: int = 0


def local_heads(n_heads: int, n_kv_heads: int, group) -> Heads:
    """The heads of the reference's heads-major ``h * hd`` column split:
    ``wq``'s ``h / M`` whole q heads a rank (``n_heads % M == 0``); with
    ``n_kv_heads % M == 0`` whole kv heads too, q heads ``m h / M ...``
    reading kv heads ``m hk / M ...``; else ``wk`` / ``wv`` hold a slice of
    a kv head's columns (paligemma's one kv head) and the rank's q heads
    must lie in one kv head's group, which it then attends with whole
    after a gather."""
    m = group.model_size
    if n_heads % m == 0:
        q = n_heads // m
        if n_kv_heads % m == 0:
            return Heads(q, n_kv_heads // m)
        group_size = n_heads // n_kv_heads
        if group_size % q == 0:
            return Heads(q, 1, True, group.model_index * q // group_size)
    raise ValueError(
        f"tensor-parallel attention splits whole q heads: {n_heads} heads "
        f"/ {n_kv_heads} kv heads over a model axis of {m} (n_heads % M "
        "must be 0, and n_kv_heads % M 0 or a rank's q heads inside one kv "
        "head's group)")


def embedding(p, tokens: torch.Tensor, group, dtype=_F32) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's rows ``m V / M ...``
    of the vocab-parallel table: a masked lookup of the rows this rank
    holds, summed over the model axis."""
    table = p["table"]
    rows = table.shape[0]
    local = tokens.to(torch.int64) - group.model_index * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(dtype)
    x = x * mine.unsqueeze(-1).to(dtype)
    return reduce_from_model(x, group)


def embedding_columns(p, tokens: torch.Tensor, group, dtype=_F32
                      ) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's columns ``m d / M
    ...`` of the d_model-sharded table: the rows looked up, then gathered
    over the model axis."""
    x = p["table"][tokens.to(torch.int64)].to(dtype)
    return gather_from_model(x, group, -1)


def cross_entropy_loss(local_logits: torch.Tensor, labels: torch.Tensor,
                       group) -> torch.Tensor:
    """The mean token cross-entropy over vocab-parallel logits (this
    rank's ``V / M`` columns, the vocab's slice ``m V / M ...``), in f32:
    the max over every shard (detached), the sum of the exponentials and
    the gold logit from the shard that holds it, each summed over the
    model axis, then ``lse - gold`` as
    :func:`repro_torch.nn.module.cross_entropy_loss` takes it."""
    z = local_logits.to(_F32)
    width = z.shape[-1]
    mx = max_from_model(torch.amax(z.detach(), dim=-1), group)
    sumexp = reduce_from_model(
        torch.sum(torch.exp(z - mx.unsqueeze(-1)), dim=-1), group)
    local = labels.to(torch.int64) - group.model_index * width
    mine = (local >= 0) & (local < width)
    gold = torch.gather(z, -1, local.clamp(0, width - 1).unsqueeze(-1))[..., 0]
    gold = reduce_from_model(gold * mine.to(_F32), group)
    return torch.mean(mx + torch.log(sumexp) - gold)


# ---------------------------------------------------------------------------
# the sharded replica
# ---------------------------------------------------------------------------

def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def check_shardable(specs, model_size: int) -> None:
    """Refuse a tree of :class:`repro_torch.nn.module.Spec` whose sharded
    dimension ``model_size`` does not divide, naming the leaf and its
    size: a shard is never padded."""
    for path, spec in _walk(specs):
        dim = spec.model_dim
        if dim is not None and spec.shape[dim] % model_size:
            raise ValueError(
                f"leaf {path!r} of shape {spec.shape} has {spec.shape[dim]} "
                f"along its model-sharded dimension {dim}, which a model "
                f"axis of {model_size} does not divide (shards are never "
                "padded)")


def shard_hook(group, leaf=None):
    """A :class:`repro_torch.nn.module.Hooked` hook (``with_spec``) that
    draws each full leaf and keeps this rank's shard of it, so a sharded
    replica holds exactly the one-card parameters' slices; then ``leaf``
    (a plain hook) when given."""
    def hook(draw, shape, dtype, spec):
        def one():
            return model_shard(draw(), spec.model_dim, group.model_index,
                               group.model_size).clone()
        if leaf is None:
            return one()
        local = list(shape)
        if spec.model_dim is not None:
            local[spec.model_dim] //= group.model_size
        return leaf(one, tuple(local), dtype)
    return hook
