"""The DP perturbation of the clipped samples' mean (``ops.dp_mean_noise``,
the ``mean_noise`` kernel on the card) and the DP gradient around it
(``core.clipping.dp_gradient``), on the CPU.

* The CUDA kernel's addressing and order written out in numpy (a thread's
  8 consecutive elements of one output tile, sample s of group g at plane
  row ``(g * b + s) * T + t``, the samples added in batches of 8 in sample
  order onto +0.0, the product with ``RN(1 / b)``, then ``RN(sigma * z)``
  added) against ``ops.dp_mean_noise``'s plain version: bitwise, f32 and
  bf16 samples with -0.0 among them, every group count, sample count and
  row length the algorithms give.
* The port's DP mean at b = 3 (mode none, so every clip factor is exactly
  1 and only the mean's rounding is compared) against the reference's
  ``clipped_grad_accumulate`` under ``jax.jit``, whose ``acc / b`` XLA
  turns into a product with ``RN(1 / b)``: bitwise.  The test also shows
  that the correctly rounded quotient differs on these inputs, so it pins
  the rounding.
* ``dp_gradient`` against the reference's ``clipped_grad_accumulate`` then
  ``g + sigma * z`` with the same noise: atol 1e-6 (the norms' sums are
  taken in other orders, and XLA may contract the noise term into an FMA).
* ``dp_gradient``'s own draws: leaf by leaf in tree order, in the mean's
  shapes and dtypes, as the DP steps drew them before the fusion.
* The wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as JC
from repro_torch import convert
from repro_torch.core import clipping as TC
from repro_torch.kernels import flatten as TFL
from repro_torch.kernels import ops

torch.set_num_threads(1)

TILE = TFL.TILE
VEC, TILE_VECS, BATCH = 8, TILE // 8, 8   # the kernel's kVec, kTileVecs,
                                          # kMeanBatch
# (groups, b, T): one and ten groups (DP-SGD, the agents), the samples of a
# batch, rows of one tile (the quickstart), 7 (the MLP), 63 (10 agents'
# MLP gradient as one row)
SHAPES = [(1, 1, 1), (10, 3, 1), (1, 32, 7), (10, 8, 7), (1, 3, 63),
          (10, 1, 63)]


def _planes(seed, groups, b, tiles, dt):
    """Clipped samples (a fifth of them -0.0 or +0.0) and the f32 noise,
    as torch tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((groups * b * tiles, TILE)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = -0.0
    x[rng.random(x.shape) < 0.1] = 0.0
    z = rng.standard_normal((groups * tiles, TILE)).astype(np.float32)
    xt = torch.from_numpy(x)
    return (xt if dt == "f32" else xt.to(torch.bfloat16)), torch.from_numpy(z)


def _f32_of(planes):
    """The kernel's loads: bf16 bits in the high half of an f32."""
    if planes.dtype == torch.float32:
        return planes.numpy()
    bits = planes.view(torch.int16).numpy().view(np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _emulate(planes, groups, b, noise, sigma):
    x, z = _f32_of(planes), noise.numpy()
    tiles = x.shape[0] // (groups * b)
    v = np.arange(groups * tiles * TILE_VECS)
    o, e = v // TILE_VECS, (v % TILE_VECS) * VEC
    g, t = o // tiles, o % tiles
    cols = e[:, None] + np.arange(VEC)
    acc = np.zeros((v.size, VEC), np.float32)
    inv_b = np.float32(1) / np.float32(b)
    for s0 in range(0, b, BATCH):
        loads = [x[((g * b + s) * tiles + t)[:, None], cols]
                 for s in range(s0, min(s0 + BATCH, b))]
        for vec in loads:
            acc = acc + vec
    y = acc * inv_b
    if sigma is not None:
        y = y + np.float32(sigma) * z[o[:, None], cols]
    out = np.empty_like(z)
    out[o[:, None], cols] = y
    return out


@pytest.mark.parametrize("sigma", [None, 0.0, 0.01])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("groups,b,tiles", SHAPES)
def test_kernel_order_equals_the_plain_version(groups, b, tiles, dt, sigma):
    """sigma None: the mean alone (no noise plane given)."""
    planes, noise = _planes(groups * 100 + b * 10 + tiles, groups, b,
                            tiles, dt)
    got = (ops.dp_mean_noise(planes, groups, b) if sigma is None
           else ops.dp_mean_noise(planes, groups, b, noise, sigma))
    want = _emulate(planes, groups, b, noise, sigma)
    assert got.dtype == torch.float32 and got.shape == noise.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # a sum of -0.0 samples is +0.0, as the reference's zeros_like start
    zeros = _f32_of(planes).reshape(groups, b, -1)
    all_neg = np.all(np.signbit(zeros) & (zeros == 0), axis=1)
    if not sigma and all_neg.any():
        assert not np.signbit(got.numpy().reshape(groups, -1)[all_neg]).any()


def _linear_loss_j(params, batch):
    return jnp.mean(batch @ params["w"] + params["b"])


def _linear_loss_t(params, batch):
    return torch.mean(batch @ params["w"] + params["b"])


def _reference_mean(agents, params, batch):
    """The reference's means of the per-sample gradients (mode none) and
    losses under jit, and the same sums divided correctly rounded
    (eager)."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jnp.asarray(batch)

    def one(p, bb):
        return JC.clipped_grad_accumulate(_linear_loss_j, p, bb, 0.3, "none")

    if agents is None:
        fn = one
    elif agents == "stacked":
        fn = jax.vmap(one)
    else:
        fn = jax.vmap(one, in_axes=(None, 0))
    return jax.jit(fn)(jp, jb), fn(jp, jb)


@pytest.mark.parametrize("port", ["dp_gradient", "clipped_grad_accumulate"])
@pytest.mark.parametrize("agents", [None, "stacked", "shared"])
def test_dp_mean_at_b3_is_the_jitted_reference_bitwise(agents, port):
    """The linear loss's per-sample gradient is its sample, exactly, in
    both packages, and with a one-hot w its per-sample loss is one sum
    ``x[0] + b``, exactly; so the means of three samples are compared
    alone, the gradients' and the losses'."""
    rng = np.random.default_rng(18)
    n, b, d = 16, 3, 2 * TILE + 5
    lead = () if agents is None else (n,)
    plead = (n,) if agents == "stacked" else ()
    w = np.zeros(plead + (d,), np.float32)
    w[..., 0] = 1.0
    params = {"w": w, "b": rng.standard_normal(plead).astype(np.float32)}
    batch = rng.standard_normal(lead + (b, d)).astype(np.float32)
    (want, want_loss), (quotient, _) = _reference_mean(agents, params, batch)
    tp, tb = convert.to_torch(params, "cpu"), torch.from_numpy(batch)
    if port == "dp_gradient":
        noise = {k: torch.zeros(lead + v.shape[len(plead):])
                 for k, v in params.items()}
        got, loss = TC.dp_gradient(_linear_loss_t, tp, tb, 0.3, 0.0,
                                   noise=noise, mode="none", agents=agents)
    else:
        got, loss = TC.clipped_grad_accumulate(_linear_loss_t, tp, tb, 0.3,
                                               "none", agents=agents)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32),
                                      err_msg=k)
    np.testing.assert_array_equal(loss.numpy().view(np.int32),
                                  np.asarray(want_loss).view(np.int32))
    # the jitted mean is not the correctly rounded quotient here
    assert not np.array_equal(np.asarray(want["w"]), np.asarray(quotient["w"]))


def _logreg_loss_j(params, batch):
    f, l = batch
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _logreg_loss_t(params, batch):
    f, l = batch
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


@pytest.mark.parametrize("mode", ["smooth", "piecewise", "none"])
@pytest.mark.parametrize("agents", [None, "stacked", "shared"])
def test_dp_gradient_is_the_reference_mean_plus_noise(agents, mode):
    rng = np.random.default_rng(22)
    n, b, d, sigma = 4, 5, 17, 0.05
    lead = () if agents is None else (n,)
    plead = (n,) if agents == "stacked" else ()
    params = {"w": rng.standard_normal(plead + (d,)).astype(np.float32),
              "b": rng.standard_normal(plead).astype(np.float32)}
    batch = ((rng.random(lead + (b, d)) < 0.3).astype(np.float32),
             (rng.random(lead + (b,)) < 0.5).astype(np.float32))
    noise = {k: rng.standard_normal(lead + v.shape[len(plead):])
             .astype(np.float32) for k, v in params.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def one(p, bb, z):
        g, loss = JC.clipped_grad_accumulate(_logreg_loss_j, p, bb, 0.3, mode)
        return jax.tree_util.tree_map(lambda a, zz: a + sigma * zz, g,
                                      z), loss

    fn = {None: one, "stacked": jax.vmap(one),
          "shared": jax.vmap(one, in_axes=(None, 0, 0))}[agents]
    g_j, loss_j = jax.jit(fn)(jp, jb, jax.tree_util.tree_map(jnp.asarray,
                                                             noise))
    g_t, loss_t = TC.dp_gradient(
        _logreg_loss_t, convert.to_torch(params, "cpu"),
        convert.to_torch(batch, "cpu"), 0.3, sigma,
        noise=convert.to_torch(noise, "cpu"), mode=mode, agents=agents)
    for k in params:
        assert g_t[k].dtype == torch.float32
        assert g_t[k].shape == noise[k].shape
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("agents", [None, "stacked", "shared"])
def test_dp_gradient_draws_the_noise_leaf_by_leaf(agents):
    """``gen`` gives the noise the DP steps drew from it before the fusion:
    ``torch.randn`` in the mean's shape and dtype, leaf by leaf in tree
    order; and it draws nothing else."""
    rng = np.random.default_rng(4)
    n, b, d = 3, 4, 9
    lead = () if agents is None else (n,)
    plead = (n,) if agents == "stacked" else ()
    params = convert.to_torch(
        {"w": rng.standard_normal(plead + (d,)).astype(np.float32),
         "b": rng.standard_normal(plead).astype(np.float32)}, "cpu")
    batch = convert.to_torch(
        ((rng.random(lead + (b, d)) < 0.3).astype(np.float32),
         (rng.random(lead + (b,)) < 0.5).astype(np.float32)), "cpu")
    drawn = torch.Generator().manual_seed(5)
    got, _ = TC.dp_gradient(_logreg_loss_t, params, batch, 0.3, 0.1,
                            gen=drawn, agents=agents)
    given = torch.Generator().manual_seed(5)
    noise = {k: torch.randn(lead + tuple(v.shape[len(plead):]),
                            generator=given, dtype=v.dtype)
             for k, v in sorted(params.items())}
    want, _ = TC.dp_gradient(_logreg_loss_t, params, batch, 0.3, 0.1,
                             noise=noise, agents=agents)
    for k in params:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(drawn.get_state(), given.get_state())


@pytest.mark.parametrize("call,err,match", [
    (lambda: ops.dp_mean_noise(torch.zeros(6, TILE, dtype=torch.float64), 1,
                               2, torch.zeros(3, TILE), 0.1),
     TypeError, "f32 or bf16"),
    (lambda: ops.dp_mean_noise(torch.zeros(6, TILE), 1, 2,
                               torch.zeros(3, TILE, dtype=torch.bfloat16),
                               0.1), TypeError, "float32"),
    (lambda: ops.dp_mean_noise(torch.zeros(7, TILE), 1, 2,
                               torch.zeros(3, TILE), 0.1),
     ValueError, "divides"),
    (lambda: ops.dp_mean_noise(torch.zeros(6, TILE), 2, 2,
                               torch.zeros(3, TILE), 0.1),
     ValueError, "divides"),
    (lambda: ops.dp_mean_noise(torch.zeros(6, TILE), 1, 2,
                               torch.zeros(2, TILE), 0.1),
     ValueError, "noise plane of shape"),
    (lambda: ops.dp_mean_noise(torch.zeros(6, TILE), 1, 0,
                               torch.zeros(3, TILE), 0.1),
     ValueError, "divides"),
], ids=["planes_f64", "noise_bf16", "rows_not_a_multiple_of_b",
        "rows_not_a_multiple_of_groups_b", "noise_shape", "b_zero"])
def test_dp_mean_noise_refuses(call, err, match):
    with pytest.raises(err, match=match):
        call()
