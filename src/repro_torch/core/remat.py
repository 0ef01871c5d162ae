"""Rematerialisation around the loss (``src/repro/api.py::_apply_remat``).

The registered algorithms differentiate the loss inside their step
(``torch.func.grad_and_value`` under ``vmap``), so remat around the loss
function is remat around the loss and its gradient, as the reference's
``jax.checkpoint(loss_fn)``:

* ``"full"`` keeps only the loss's inputs (the parameter leaves and the
  batch) from the forward, and the backward runs the forward again under
  ``torch.func.vjp`` to get its activations.
* ``"dots"`` (``jax.checkpoint_policies.dots_saveable``) keeps, beside the
  inputs, the outputs of the forward's dense products (``mm``, ``bmm``,
  ``addmm``, ``linear``, ``matmul``); the recompute takes them back in the
  order the forward made them and computes only the rest.  It raises if
  its products do not line up with the records, key for key and in
  order, or if it leaves a record unused.

``torch.utils.checkpoint`` cannot serve here: under ``torch.func.grad`` its
non-reentrant form fails ("don't yet support saved tensor hooks") and its
reentrant form has no ``setup_context``.  So both policies are one
``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule``, which ``torch.func`` differentiates and vmaps.  The
products of ``"dots"`` are recorded and replayed by a
``TorchDispatchMode``, which sees them below the ``torch.func`` transforms
as the kernels that run (a vmapped ``mm`` arrives as one ``mm`` or
``bmm`` of the whole batch).  The recorded products come out of the
Function's forward as extra outputs that carry no gradient.

The gradient is the same function of the same inputs either way: on the
CPU it is bitwise the gradient without remat.

Around the tensor-parallel loss of a model axis
(:mod:`repro_torch.nn.tensor_parallel`) both policies run as they are:
the collectives' ``autograd.Function`` s and their ``vmap`` rules nest
inside the generated rule, and the dispatch modes pass the collectives
through unrecorded, as every op that is not a dense product.  The
recompute then issues the forward's model-axis collectives once more a
gradient (under "dots" too: only the products are replayed), and nothing
on the agent axes.
"""

from __future__ import annotations

from typing import Callable, Optional

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..tree import tree_flatten, tree_unflatten

__all__ = ["apply_remat", "DOTS_REPLAYS"]

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                   _aten.linear.default, _aten.matmul.default,
                   _aten.baddbmm.default})
# the recompute's products under "dots": taken from the forward
# ("replayed") or computed again ("computed")
DOTS_REPLAYS = collections.Counter()


def _key(func, args):
    """A product by its op and its operands' shapes and dtypes."""
    return (func,) + tuple((tuple(a.shape), a.dtype) for a in args
                           if isinstance(a, torch.Tensor))


class _Record(TorchDispatchMode):
    """Keeps the output of each dense product, in order, with its key."""

    def __init__(self):
        super().__init__()
        self.keys, self.outputs = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self.keys.append(_key(func, args))
            self.outputs.append(out)
        return out


def _plain(t):
    """The tensor below its ``torch.func`` grad wrappers: a product saved
    from the forward comes back into the backward wrapped at the outer
    transform's level, and a dispatch mode deals in plain tensors."""
    f = torch._C._functorch
    while f.is_gradtrackingtensor(t):
        t = f.get_unwrapped(t)
    return t


class _Replay(TorchDispatchMode):
    """Hands back, for each product of the recompute, the forward's product
    at the same place in the forward's order.  A product of a key that the
    forward never made (autograd may route a ``matmul`` through another op
    than the forward took) is computed.  A product of a recorded key out of
    the forward's order, or a record that the recompute leaves unused,
    raises: the records would no longer stand for the products they
    replace."""

    def __init__(self, keys, outputs):
        super().__init__()
        self.keys, self.outputs = keys, outputs
        self.recorded = frozenset(keys)
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = _key(func, args) if func in _DOTS else None
        if key is None or key not in self.recorded:
            if key is not None:
                DOTS_REPLAYS["computed"] += 1
            return func(*args, **(kwargs or {}))
        i = self.next
        if i >= len(self.keys) or self.keys[i] != key:
            want = self.keys[i] if i < len(self.keys) else "none"
            raise RuntimeError(
                f"remat 'dots': recompute product {i} is {key}, the "
                f"forward's is {want}")
        self.next = i + 1
        DOTS_REPLAYS["replayed"] += 1
        return _plain(self.outputs[i])

    def drained(self):
        """Raises unless the recompute took every record."""
        if self.next != len(self.keys):
            raise RuntimeError(
                f"remat 'dots': the recompute took {self.next} of the "
                f"forward's {len(self.keys)} products")


class _Remat(torch.autograd.Function):
    """``run(*params, *batch) -> scalar``; saves the inputs (and under
    ``dots`` the products) and recomputes in the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, n_params, dots, *args):
        if not dots:
            return run(*args)
        params, rest = args[:n_params], args[n_params:]
        # under vjp, as the recompute runs: an op may take another route
        # when its operands track grad (a ``matmul`` folds its batch into
        # one ``mm``), and the records must be the recompute's products
        with _Record() as rec:
            loss, _ = torch.func.vjp(lambda *p: run(*p, *rest), *params)
        run.keys = rec.keys      # for setup_context, which sees run
        return (loss, *rec.outputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, n_params, dots = inputs[:3]
        ctx.run, ctx.n_params, ctx.dots = run, n_params, dots
        ctx.keys = getattr(run, "keys", None)
        saved = list(inputs[3:])
        if dots:
            ctx.mark_non_differentiable(*output[1:])
            saved += list(output[1:])
        ctx.save_for_backward(*saved)

    @staticmethod
    def backward(ctx, g, *unused):
        del unused
        saved = ctx.saved_tensors
        n_args = len(ctx.needs_input_grad) - 3
        args, records = saved[:n_args], saved[n_args:]
        params, rest = args[:ctx.n_params], args[ctx.n_params:]

        def loss(*p):
            return ctx.run(*p, *rest)

        if ctx.dots:
            with _Replay(ctx.keys, records) as replay:
                _, vjp = torch.func.vjp(loss, *params)
            replay.drained()
        else:
            _, vjp = torch.func.vjp(loss, *params)
        grads = vjp(g)
        return (None, None, None, *grads, *([None] * len(rest)))


def apply_remat(loss_fn: Callable, policy: Optional[str]) -> Callable:
    """``loss_fn`` wrapped per ``policy`` (None, ``"full"`` or ``"dots"``;
    the module docstring says what each keeps)."""
    if policy is None:
        return loss_fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}; have None, "
                         "'full', 'dots'")
    dots = policy == "dots"

    def remat_loss(params, batch):
        p_leaves, p_def = tree_flatten(params)
        b_leaves, b_def = tree_flatten(batch)
        n = len(p_leaves)

        def run(*leaves):
            return loss_fn(tree_unflatten(p_def, list(leaves[:n])),
                           tree_unflatten(b_def, list(leaves[n:])))

        out = _Remat.apply(run, n, dots, *p_leaves, *b_leaves)
        return out[0] if dots else out

    return remat_loss
