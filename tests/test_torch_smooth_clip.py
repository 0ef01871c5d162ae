"""The smooth-clip kernels' wrappers against the JAX reference on the CPU
(numpy-seeded inputs through both packages); the row-stacked clip and the
algorithms' paths through them are in ``test_torch_clip_path.py``.

On the CPU the wrappers (``ops.clip_sumsq``, ``ops.clip_scale``,
``ops.smooth_clip``) run the kernels' plain versions, whose order of
operations the CUDA kernels repeat bit for bit on the card
(``chip_smoke.py`` phase 8).  Tolerances, each with its reason:

* ``ops.smooth_clip`` against the Pallas kernel (interpret mode) and the
  reference's ``smooth_clip_ref``: rtol 1e-6 in f32, 2^-7 in bf16; the sum
  of squares is taken in another order (the kernel's 1024 partials of 8
  and a halving tree against XLA's), which moves the factor by an ulp or
  two.  In bf16 that can flip the final rounding by one bf16 unit, which
  is 2^-8 to 2^-7 of the value (2^-8 alone failed 4 of the 40 bf16
  cases).  With noise, ``x * f + sigma * z`` can cancel, so the f32 check
  adds an absolute 1e-6 of the output's largest magnitude;
* exact: ``clip_sumsq`` against its order written out in numpy, the clip
  factor at tau = 0.3 against the reference's (a correctly rounded f32
  quotient on both sides), ``clip_scale`` at factor 1 against the
  perturbation ``g + sigma * z``; ``smooth_factors`` against the fused
  kernel's order over a row's partials written out in numpy, and
  ``clip_planes`` / ``stacked_clip`` against their plain composition;
* exact against the reference, too: norms, clip factors and clips of
  sums that are exact in any order (n ones, two nonzero values), whose
  f32 square root PyTorch's CPU ``torch.sqrt`` can round an ulp low.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as JC
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch import convert
from repro_torch.core import clipping as TC
from repro_torch.kernels import flatten as TFL
from repro_torch.kernels import ops, ref
from torch.func import vmap

torch.set_num_threads(1)

TILE = TFL.TILE
SIGMA = 0.25
SHAPES = [(7,), (1023,), (8192,), (3, 2048), (5, 1000, 3)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dt):
    """The same array in both packages, in dtype ``dt`` ('f32' / 'bf16')."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        DTYPES[dt][0])
    return j, convert.to_torch(np.asarray(j), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("noisy", [False, True], ids=["clip", "clip+noise"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tau", [0.3, 0.5, 1.0, 4.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_smooth_clip_equals_reference(shape, tau, dt, noisy):
    rng = np.random.default_rng(10 * SHAPES.index(shape) + int(10 * tau))
    xj, xt = _pair(rng, shape, dt)
    zj, zt = _pair(rng, shape, dt)
    if noisy:
        want = (JO.smooth_clip(xj, tau, zj, SIGMA, interpret=True),
                JR.smooth_clip_ref(xj, tau, zj, SIGMA))
        got = ops.smooth_clip(xt, tau, zt, SIGMA)
    else:
        want = (JO.smooth_clip(xj, tau, interpret=True),
                JR.smooth_clip_ref(xj, tau))
        got = ops.smooth_clip(xt, tau)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    for w in want:
        w = _f32(w)
        if dt == "bf16":
            tol = dict(rtol=2.0 ** -7, atol=0.0)
        else:
            tol = dict(rtol=1e-6,
                       atol=1e-6 * float(np.abs(w).max()) if noisy else 0.0)
        np.testing.assert_allclose(_f32(got), w, **tol)
    # the port's own plain version of Definition 2 (a library norm)
    np.testing.assert_allclose(
        _f32(ref.smooth_clip_ref(xt, tau, zt if noisy else None, SIGMA)),
        _f32(want[1]), rtol=2.0 ** -7 if dt == "bf16" else 1e-6,
        atol=1e-6 * float(np.abs(_f32(want[1])).max()) if noisy else 0.0)


def _numpy_sumsq(planes):
    """The kernel's order in numpy f32: 1024 partials, each the sequential
    sum of its 8 consecutive squares, then a halving tree."""
    sq = planes * planes
    parts = sq.reshape(planes.shape[0], -1, 8)
    s = parts[..., 0]
    for j in range(1, 8):
        s = s + parts[..., j]
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_clip_sumsq_is_the_fixed_order(dt):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((3 * rng.standard_normal((5, TILE))).astype(
        np.float32)).to(DTYPES[dt][1])
    got = ops.clip_sumsq(x)
    assert got.dtype == torch.float32 and got.shape == (5,)
    want = _numpy_sumsq(x.float().numpy())
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["smooth", "piecewise"])
def test_clip_factor_is_the_true_quotient(mode):
    """tau = 0.3 is not a power of two: ``0.3 / tensor`` in PyTorch is
    ``RN(RN(1 / t) * 0.3)``, one ulp off in about a quarter of cases; the
    factor must be the reference's correctly rounded quotient."""
    tau = 0.3
    norms = np.random.default_rng(4).uniform(0, 10, 4000).astype(np.float32)
    norms[:4] = [0.0, 1e-31, 0.7, 9.25]
    want = np.asarray(JC.clip_factor(jnp.asarray(norms), tau, mode))
    got = TC.clip_factor(torch.from_numpy(norms), tau, mode).numpy()
    np.testing.assert_array_equal(got, want)
    if mode == "smooth":
        # the kernel path's combine gives the same factor
        sums = torch.from_numpy(norms.astype(np.float64) ** 2).float()
        np.testing.assert_array_equal(
            ops.smooth_factors(sums, 4000, tau).numpy(),
            np.asarray(JC.clip_factor(jnp.sqrt(jnp.asarray(sums.numpy())),
                                      tau, mode)))
        # the reciprocal form the port computed before differs
        recip = (tau / (tau + torch.from_numpy(norms))).numpy()
        assert (recip != want).sum() > 100


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_clip_scale_at_factor_one_is_the_perturbation(dt):
    """``scale_noise`` at f = 1: ``x * 1`` is exact, so the result is
    ``leaf + sigma * z`` as PyTorch computes it (each product rounded in
    f32 before the add) -- in bf16, computed in f32 and rounded once."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((6, TILE)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((6, TILE)).astype(np.float32))
    g, z = g.to(DTYPES[dt][1]), z.to(DTYPES[dt][1])
    got = ops.clip_scale(g, torch.ones(3), z, 0.05)
    want = (g.float() + 0.05 * z.float()).to(g.dtype)
    assert got.dtype == g.dtype
    assert torch.equal(got.view(torch.int16 if dt == "bf16" else torch.int32),
                       want.view(torch.int16 if dt == "bf16"
                                 else torch.int32))


def test_clip_scale_takes_one_factor_a_row():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, TILE)).astype(np.float32)
    f = np.array([0.5, 0.1, 3.0], np.float32)
    got = ops.clip_scale(torch.from_numpy(x), torch.from_numpy(f))
    np.testing.assert_array_equal(got.numpy(), x * np.repeat(f, 2)[:, None])


@pytest.mark.parametrize("call,match", [
    (lambda: ops.clip_sumsq(torch.zeros(3, 100)), "rows"),
    (lambda: ops.clip_sumsq(torch.zeros(2, TILE, dtype=torch.float16)),
     "f32 or bf16"),
    (lambda: ops.clip_scale(torch.zeros(4, TILE), torch.ones(3)), "divides"),
    (lambda: ops.clip_scale(torch.zeros(4, TILE), torch.ones(2),
                            torch.zeros(4, TILE, dtype=torch.bfloat16)),
     "takes"),
    (lambda: ops.smooth_clip(torch.zeros(5), 1.0, torch.zeros(6)), "noise"),
    (lambda: ops.clip_planes(torch.zeros(4, TILE), 3, 1.0), "divides"),
    (lambda: ops.clip_planes(torch.zeros(4, TILE), 0, 1.0), "divides"),
    (lambda: ops.clip_planes(torch.zeros(4, TILE), 2, 1.0,
                             torch.zeros(4, TILE, dtype=torch.bfloat16)),
     "takes"),
    (lambda: ops.clip_planes(torch.zeros(4, 100), 2, 1.0), "rows"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises((ValueError, TypeError), match=match):
        call()


# sums of squares whose f32 square root PyTorch's CPU ``torch.sqrt`` rounds
# one ulp low (``sqrt(267.0)``); XLA's, the card's and ``ref.sqrt_rn`` are
# correctly rounded
MISROUNDED_SUMS = (267, 999, 1068, 1171, 1230, 1421, 1633)


def _ones(n, width=2048):
    """Rows of n ones (the second negative) in zeros: sums of squares n."""
    x = np.zeros((2, width), np.float32)
    x[0, :n] = 1.0
    x[1, -n:] = -1.0
    return x


@pytest.mark.parametrize("n", MISROUNDED_SUMS)
def test_misrounded_sums_clip_as_the_reference(n):
    x = _ones(n)
    tree = {"a": x[0, :1000], "b": x[0, 1000:]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = convert.to_torch(tree, "cpu")
    norm = TC.tree_global_norm(tt)
    assert torch.sqrt(torch.tensor(float(n))) != norm   # the fault's input
    np.testing.assert_array_equal(_f32(norm), _f32(JC.tree_global_norm(jt)))
    for mode in ("smooth", "piecewise"):
        got, want = TC.tree_clip(tt, 0.3, mode), JC.tree_clip(jt, 0.3, mode)
        for k in tree:
            np.testing.assert_array_equal(_f32(got[k]), _f32(want[k]))
    # each row by its own norm, through clip_planes, against vmap(tree_clip)
    rows = {"w": x}
    got = TC.stacked_clip(convert.to_torch(rows, "cpu"), 0.3)
    want = jax.vmap(lambda t: JC.tree_clip(t, 0.3))(
        jax.tree_util.tree_map(jnp.asarray, rows))
    np.testing.assert_array_equal(_f32(got["w"]), _f32(want["w"]))
    # one norm over the array, against the Pallas kernel (interpret mode)
    np.testing.assert_array_equal(
        _f32(ops.smooth_clip(torch.from_numpy(x), 0.3)),
        _f32(JO.smooth_clip(jnp.asarray(x), 0.3, interpret=True)))


def test_two_value_sums_clip_as_the_reference():
    """Rows with two nonzero values (a sum of two squares, the same in any
    order): each row's norm and smooth-clip factor, and the clipped rows
    where ``torch.sqrt`` misrounds, bitwise the reference's."""
    rng = np.random.default_rng(21)
    n = 20000
    x = np.zeros((n, 6), np.float32)
    x[:, 1] = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    x[:, 4] = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    tree = {"w": x}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = convert.to_torch(tree, "cpu")
    j_norm = np.asarray(jax.vmap(JC.tree_global_norm)(jt))
    t_norm = vmap(TC.tree_global_norm)(tt)
    np.testing.assert_array_equal(t_norm.numpy(), j_norm)
    sums = torch.from_numpy(x[:, 1] * x[:, 1] + x[:, 4] * x[:, 4])
    bad = torch.nonzero(torch.sqrt(sums) != t_norm).flatten()
    assert bad.numel() >= 20
    np.testing.assert_array_equal(
        ops.smooth_factors(sums, n, 0.3).numpy(),
        np.asarray(JC.clip_factor(jnp.asarray(j_norm), 0.3, "smooth")))
    rows = {"w": x[bad[:64].numpy()]}
    got = TC.stacked_clip(convert.to_torch(rows, "cpu"), 0.3)
    want = jax.vmap(lambda t: JC.tree_clip(t, 0.3))(
        jax.tree_util.tree_map(jnp.asarray, rows))
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))


def _emulate_row_factors(partials, rows, tau):
    """The fused kernel's factor of each row, in numpy f32: lane l of a
    warp adds the row's partials l, l + 32, ... in sequence from +0.0, then
    the shuffle tree (lane i takes lane i + off, off = 16 ... 1; a lane
    past the warp's end gives its own value), then the correctly rounded
    square root, tau + norm and tau / (tau + norm)."""
    p = partials.reshape(rows, -1)
    lanes = np.zeros((rows, 32), np.float32)
    for lane in range(32):
        for i in range(lane, p.shape[1], 32):
            lanes[:, lane] = lanes[:, lane] + p[:, i]
    for off in (16, 8, 4, 2, 1):
        down = np.concatenate([lanes[:, off:], lanes[:, 32 - off:]], axis=1)
        lanes = lanes + down
    t = np.float32(tau)
    return t / (t + np.sqrt(lanes[:, 0]))


def _partials(rng, n):
    """Sums of squares over a wide range, so the order of adds shows."""
    return (rng.standard_normal(n) ** 2
            * 10.0 ** rng.uniform(-4, 4, n)).astype(np.float32)


@pytest.mark.parametrize("tiles", [1, 7, 31, 32, 33, 63, 128, 2048])
def test_smooth_factors_take_the_fused_kernels_row_order(tiles):
    rng = np.random.default_rng(tiles)
    rows = 3
    p = _partials(rng, rows * tiles)
    p[:tiles // 2] = 0.0          # zero partials (all-zero tiles)
    for tau in (0.3, 1.0, 4.0):
        got = ops.smooth_factors(torch.from_numpy(p), rows, tau).numpy()
        np.testing.assert_array_equal(
            got.view(np.uint32),
            _emulate_row_factors(p, rows, tau).view(np.uint32))


@pytest.mark.parametrize("noisy", [False, True], ids=["clip", "clip+noise"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_clip_planes_is_the_plain_composition(dt, noisy):
    """``clip_planes`` (the fused kernel's CPU path) returns the clip,
    the partials and the factors of ``clip_sumsq``, the row order of
    ``_emulate_row_factors`` and ``clip_scale``, bit for bit."""
    rng = np.random.default_rng(31)
    rows, tiles = 4, 3
    x = torch.from_numpy((3 * rng.standard_normal((rows * tiles, TILE)))
                         .astype(np.float32)).to(DTYPES[dt][1])
    z = torch.from_numpy(rng.standard_normal((rows * tiles, TILE))
                         .astype(np.float32)).to(DTYPES[dt][1])
    z = z if noisy else None
    out, partials, factors = ops.clip_planes(x, rows, 0.3, z, SIGMA)
    want_p = ops.clip_sumsq(x)
    want_f = _emulate_row_factors(want_p.numpy(), rows, 0.3)
    want = ops.clip_scale(x, torch.from_numpy(want_f), z, SIGMA)
    assert torch.equal(partials, want_p)
    np.testing.assert_array_equal(factors.numpy().view(np.uint32),
                                  want_f.view(np.uint32))
    as_int = torch.int16 if dt == "bf16" else torch.int32
    assert out.dtype == x.dtype
    assert torch.equal(out.view(as_int), want.view(as_int))


def test_stacked_clip_is_the_plain_composition():
    """The row-stacked clip of a mixed tree: its flat plane through
    ``clip_sumsq``, the fused kernel's row order and ``clip_scale``."""
    rng = np.random.default_rng(32)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 300, 40))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((5, 7))
                                  .astype(np.float32)).to(torch.bfloat16)}
    got = TC.stacked_clip(tree, 0.3)
    spec = TFL.flat_spec(tree)
    planes = TFL.to_planes(tree, spec)
    f = _emulate_row_factors(ops.clip_sumsq(planes).numpy(), spec.rows, 0.3)
    want = TFL.from_planes(ops.clip_scale(planes, torch.from_numpy(f)), spec)
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], want[k])
