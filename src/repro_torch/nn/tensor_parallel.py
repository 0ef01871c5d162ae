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
* :func:`max_from_model` -- the max over the shards, with no gradient.

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
then ``lse - gold``).  :func:`check_shardable` refuses a leaf whose
sharded dimension the model axis does not divide; nothing is padded.
"""

from __future__ import annotations

import torch

from ..core.agents import model_shard
from .module import dense

__all__ = ["copy_to_model", "reduce_from_model", "max_from_model",
           "column_dense", "row_dense", "embedding", "cross_entropy_loss",
           "check_shardable", "local_heads", "shard_hook"]

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


for _fn in (_Copy, _Reduce, _Max):
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


def local_heads(n_heads: int, n_kv_heads: int, group):
    """The heads a rank holds: whole heads, contiguous, the reference's
    heads-major split of ``h * hd`` columns.  Requires ``n_kv_heads % M ==
    0``; q heads ``m h / M ...`` then read kv heads ``m hk / M ...``."""
    m = group.model_size
    if n_kv_heads % m or n_heads % m:
        raise ValueError(
            f"tensor-parallel attention splits whole heads: {n_heads} "
            f"heads / {n_kv_heads} kv heads over a model axis of {m} "
            "(n_kv_heads % M must be 0)")
    return n_heads // m, n_kv_heads // m


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
