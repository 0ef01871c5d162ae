"""The port's bit-packed wire layouts and the plain versions of its four
codec kernels against the JAX reference (``repro.core.wire_formats`` and
``repro.kernels.ops.wire_*`` in interpret mode) on the same windows.

Tolerances, each with its reason:

* exact: layout constants and byte counts (integer arithmetic); the top-k
  pack (the same bisection, the same index-order selection, a bf16 cast)
  and every unpack (a copy or one f32 product per element); qsgd words and
  scales on windows of small integers, whose sum of squares is exact in
  f32 in any order;
* qsgd on Gaussian windows: the scale within 2 f32 ulps, because the
  reference sums the 2048 squares in XLA's order and the port in the
  kernel's fixed order (``ref.qsgd_sumsq``): the sums differ by a few ulps,
  the square root halves that, and the division by ``levels * (1 +
  omega)`` rounds once more (1 ulp was expected; 2 occur).  The unpacked
  window within one quantisation step times the scale, with at most 0.1 %
  of the codes different (a code moves only when its uniform falls within
  an ulp-sized sliver of the rounding probability);
* exact, too: ``topk_pack``'s threshold from the k-th largest magnitude
  and an emulation of the CUDA kernel's selection, on the magnitudes each
  package computes with (XLA on the CPU flushes subnormals, the port does
  not);
* the Pallas kernel in interpret mode: its qsgd scale within 1 ulp even on
  exact sums, because under jit XLA turns the division by the constant
  ``levels * (1 + omega)`` into a product with its reciprocal, which the
  reference's own ``qsgd_pack_ref`` (and the port) do not;
* the Pallas ``topk_unpack`` on 512 slots over 16 indices: within (n - 1)
  eps sum |v| of the slot-order sums, because its one-hot product is an
  XLA dot, which adds the terms in blocks; on shorter windows, and the
  order-dependent triple, it is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire_formats as JWF
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import wire_formats as TWF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

import radix_select_emulation as RSE

torch.set_num_threads(1)

# one compiled program per shape instead of one per eager op
_topk_pack_ref = jax.jit(JWF.topk_pack_ref, static_argnums=1)
_topk_unpack_ref = jax.jit(JWF.topk_unpack_ref)

LEVELS = (1, 3, 7, 16, 255)
FRACS = (0.05, 0.25, 1 / 2048)


def _windows(kind, d, seed=0):
    """f32 windows of a d-vector: 'gauss', 'ints' (tied magnitudes),
    'sparse' (fewer nonzeros than k, an all-zero window, a -0)."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        x = rng.standard_normal(d)
    elif kind == "ints":
        x = rng.integers(-3, 4, d)
    else:
        x = np.zeros(d)
        hot = rng.choice(d, size=max(d // 100, 1), replace=False)
        x[hot] = rng.integers(-3, 4, hot.size)
    x = x.astype(np.float32)
    rows = np.array(JWF.to_windows(jnp.asarray(x)))
    if kind == "sparse" and rows.shape[0] > 1:
        rows[-1] = 0.0
        rows[0, 1] = -0.0
    return rows


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _ulps(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


def _np(t):
    return convert.wire_to_numpy(t)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("frac", FRACS)
def test_layout_constants_equal_reference(levels, frac):
    for name in ("PACK_BLOCK", "N_BISECT_ITERS", "WIRE_MODES",
                 "WIRE_FORMATS"):
        assert getattr(TWF, name) == getattr(JWF, name), name
    assert TWF.TOPK_VALUE_DTYPE == torch.bfloat16
    assert (torch.empty((), dtype=TWF.TOPK_INDEX_DTYPE).element_size()
            == np.dtype(JWF.TOPK_INDEX_DTYPE).itemsize)
    assert TWF.topk_keep(frac) == JWF.topk_keep(frac)
    for fn in ("qsgd_bits", "qsgd_elems_per_word", "qsgd_words_per_window",
               "qsgd_window_omega"):
        assert getattr(TWF, fn)(levels) == getattr(JWF, fn)(levels), fn
    assert TWF.qsgd_scale_denominator(levels) == float(
        np.float32(levels * (1.0 + JWF.qsgd_window_omega(levels))))
    for d in (1, 2047, 2048, 2049, 50_890):
        tf = TWF.make_wire_format("top_k", frac=frac)
        jf = JWF.make_wire_format("top_k", frac=frac)
        tq = TWF.make_wire_format("qsgd", levels=levels)
        jq = JWF.make_wire_format("qsgd", levels=levels)
        for t, j in ((tf, jf), (tq, jq)):
            assert (t.name, t.deterministic) == (j.name, j.deterministic)
            assert t.windows(d) == j.windows(d)
            assert t.buffer_bytes(d) == j.buffer_bytes(d)
            assert t.payload_bytes(d) == j.payload_bytes(d)
            assert (TWF.codec_collective_bytes(t, "packed", 10, d)
                    == JWF.codec_collective_bytes(j, "packed", 10, d))


@pytest.mark.parametrize("d", (5, 2047, 2049, 20_001))
def test_windows_round_trip_as_the_reference(d):
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    rows = TWF.to_windows(torch.from_numpy(x))
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(JWF.to_windows(jnp.asarray(x))))
    assert torch.equal(TWF.from_windows(rows, d), torch.from_numpy(x))


def test_bisect_threshold_equals_reference_per_row():
    rows = np.concatenate([_windows(k, 3 * 2048, seed=1)
                           for k in ("gauss", "ints", "sparse")])
    a = np.abs(rows)
    for k in (1, 102, 512, 2048):
        got = TWF.bisect_threshold(torch.from_numpy(a), k).numpy()
        want = jax.jit(jax.vmap(lambda r: JWF.bisect_threshold(r, k)))(a)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ("gauss", "ints", "sparse"))
@pytest.mark.parametrize("d", (5, 2049, 10_001))
@pytest.mark.parametrize("frac", (0.05, 0.25))
def test_topk_codec_is_bitwise_the_reference(kind, d, frac):
    rows = _windows(kind, d, seed=d)
    k = TWF.topk_keep(frac)
    vals, idx = tops.wire_topk_pack(torch.from_numpy(rows), k)
    assert (vals.dtype, idx.dtype) == (torch.bfloat16, torch.int16)
    j_vals, j_idx = _topk_pack_ref(jnp.asarray(rows), k)
    np.testing.assert_array_equal(_np(vals), _bits(j_vals))
    np.testing.assert_array_equal(_np(idx), np.asarray(j_idx))
    dense = tops.wire_topk_unpack(vals, idx).numpy()
    np.testing.assert_array_equal(
        _bits(dense), _bits(_topk_unpack_ref(j_vals, j_idx)))
    # the Pallas kernels (interpret mode) unpack to the same window
    p_vals, p_idx = jops.wire_topk_pack(jnp.asarray(rows), k,
                                        interpret=True)
    np.testing.assert_array_equal(
        _bits(dense),
        _bits(jops.wire_topk_unpack(p_vals, p_idx, interpret=True)))
    # and the port's unpack reads the reference's buffers
    np.testing.assert_array_equal(_bits(dense), _bits(tops.wire_topk_unpack(
        *convert.to_torch((j_vals, j_idx), "cpu")).numpy()))


# -- topk_unpack on windows topk_pack never emits ---------------------------
#
# The reference's ``.at[].add`` (and the Pallas kernel's one-hot product)
# reads each index as its u16 value, drops one at or past PACK_BLOCK and
# sums duplicates in slot order.  The port's int16 indices are the same bit
# patterns.  The CUDA kernel keeps a fast path for strictly increasing
# indices and walks the slots in order otherwise; its choice and both paths
# are emulated here.

_TWO30 = 2.0 ** 30
UNPACK_EDGE_KINDS = ("duplicates", "order", "out_of_window",
                     "increasing_tail", "dense_repeats", "packed")


def _unpack_edge_window(kind, seed=0):
    """One or two windows of (f32 values exact in bf16, u16 indices):
    duplicates with exact sums; 2^30, 1, -2^30 on one index (0 in slot
    order, 1 in most other orders) and 2^30, -2^30, 1 on another (1);
    indices 2048, 3000, 32768 and 65535 among duplicates; strictly
    increasing indices with an out-of-window tail (the fast path drops
    them); random values on 16 indices, 512 slots (sums that round); two
    windows ``topk_pack`` emits."""
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        vals = [[1, 2, 4, 8, -8, 3, 0.5, -0.0], [-0.0, -0.0, 7, 7, 1, 2, 3, 4]]
        idx = [[5, 5, 5, 9, 9, 100, 2047, 2047], [0, 0, 3, 3, 3, 2, 1, 0]]
    elif kind == "order":
        vals = [[_TWO30, 1, -_TWO30, _TWO30, -_TWO30, 1, 0.25]]
        idx = [[9, 9, 9, 4, 4, 4, 8]]
    elif kind == "out_of_window":
        vals = [[1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1]]
        idx = [[2048, 3000, 32768, 65535, 0, 2047, 7, 7],
               [65535, 32768, 7, 2048, 7, 3000, 2047, 0]]
    elif kind == "increasing_tail":
        vals = [[1, -2, 3, -0.0, 5, 6, 7, 8]]
        idx = [[0, 5, 2046, 2047, 2048, 3000, 32768, 65535]]
    elif kind == "dense_repeats":
        vals = rng.standard_normal((2, 512)) * 10.0 ** rng.integers(
            -3, 4, (2, 512))
        idx = rng.integers(0, 16, (2, 512))
    else:
        rows = _windows("gauss", 2 * 2048, seed=seed)
        j_vals, j_idx = _topk_pack_ref(jnp.asarray(rows), 102)
        return (np.array(j_vals.astype(jnp.float32)),
                np.array(j_idx).astype(np.uint16))
    vals = np.array(jnp.asarray(np.asarray(vals, np.float32),
                                  jnp.bfloat16).astype(jnp.float32))
    return vals, np.asarray(idx, np.uint16)


def _emulate_topk_unpack(vals, idx):
    """The CUDA kernel: a window whose indices rise strictly takes the fast
    path (``0 + v`` stored at each index below PACK_BLOCK); any other walks
    its slots in order, adding each onto its element's sum from +0.
    Returns (f32 windows, which windows took the ordered path)."""
    nb, k = vals.shape
    out = np.zeros((nb, TWF.PACK_BLOCK), np.float32)
    ordered = np.zeros(nb, bool)
    for w in range(nb):
        j = idx[w].astype(np.int64)
        ordered[w] = bool(np.any(j[1:] <= j[:-1]))
        for r in np.flatnonzero(j < TWF.PACK_BLOCK):
            out[w, j[r]] = np.float32(out[w, j[r]] + vals[w, r])
    return out, ordered


@pytest.mark.parametrize("kind", UNPACK_EDGE_KINDS)
def test_topk_unpack_sums_duplicates_and_drops_out_of_window(kind):
    """``ops.wire_topk_unpack`` on the CPU is bitwise the reference's
    ``topk_unpack_ref`` and the Pallas kernel (interpret mode) on any u16
    index, and so is the emulated CUDA kernel, whose fast path only the
    strictly increasing windows take."""
    vals, idx = _unpack_edge_window(kind, seed=len(kind))
    j_vals, j_idx = jnp.asarray(vals, jnp.bfloat16), jnp.asarray(idx)
    want = np.asarray(_topk_unpack_ref(j_vals, j_idx))
    got = tops.wire_topk_unpack(
        torch.from_numpy(vals).to(torch.bfloat16),
        torch.from_numpy(idx.view(np.int16))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pallas = np.asarray(jops.wire_topk_unpack(j_vals, j_idx, interpret=True))
    if kind == "dense_repeats":
        # the one-hot product (an XLA dot) adds 512 terms in blocks, not in
        # slot order: within the error bound of a sum of n terms in any
        # order, (n - 1) eps sum |v| (n <= 512)
        mag = np.zeros_like(got, np.float64)
        for w in range(vals.shape[0]):
            np.add.at(mag[w], idx[w].astype(np.int64), np.abs(vals[w]))
        eps = float(np.finfo(np.float32).eps)
        assert np.all(np.abs(pallas - got) <= vals.shape[1] * eps * mag)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(pallas))
    emulated, ordered = _emulate_topk_unpack(vals, idx)
    np.testing.assert_array_equal(_bits(emulated), _bits(got))
    assert ordered.tolist() == [kind not in ("increasing_tail", "packed")
                                ] * vals.shape[0]
    if kind == "order":     # the sums in slot order: 0 at 9, 1 at 4
        assert got[0, 9] == 0.0 and got[0, 4] == 1.0


def _ref_uniforms(key, rows):
    """The reference's stochastic-rounding draws, as ``ops.py`` makes
    them from the pack's key."""
    return np.array(jax.random.uniform(key, rows.shape, jnp.float32))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", ("ints", "sparse"))
def test_qsgd_codec_is_bitwise_the_reference_on_exact_sums(levels, kind):
    rows = _windows(kind, 4 * 2048 + 77, seed=levels)
    key = jax.random.PRNGKey(levels)
    words, scale = tops.wire_qsgd_pack(
        torch.from_numpy(rows), torch.from_numpy(_ref_uniforms(key, rows)),
        levels)
    assert (words.dtype, scale.dtype) == (torch.int32, torch.float32)
    j_words, j_scale = JWF.qsgd_pack_ref(key, jnp.asarray(rows), levels)
    np.testing.assert_array_equal(_np(words), np.asarray(j_words))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(j_scale))
    # the Pallas kernel packs the same words; its scale may sit 1 ulp off
    p_words, p_scale = jops.wire_qsgd_pack(jnp.asarray(rows), key, levels,
                                           interpret=True)
    np.testing.assert_array_equal(_np(words), np.asarray(p_words))
    assert _ulps(scale.numpy(), p_scale).max() <= 1
    dense = tops.wire_qsgd_unpack(words, scale, levels).numpy()
    np.testing.assert_array_equal(
        _bits(dense), _bits(JWF.qsgd_unpack_ref(j_words, j_scale, levels)))
    np.testing.assert_array_equal(_bits(dense), _bits(jops.wire_qsgd_unpack(
        j_words, j_scale, levels, interpret=True)))


@pytest.mark.parametrize("levels", LEVELS)
def test_qsgd_codec_on_gaussian_windows(levels):
    rows = _windows("gauss", 6 * 2048 - 5, seed=10 + levels)
    key = jax.random.PRNGKey(20 + levels)
    words, scale = tops.wire_qsgd_pack(
        torch.from_numpy(rows), torch.from_numpy(_ref_uniforms(key, rows)),
        levels)
    j_words, j_scale = JWF.qsgd_pack_ref(key, jnp.asarray(rows), levels)
    j_scale = np.asarray(j_scale)
    assert _ulps(scale.numpy(), j_scale).max() <= 2
    ones = torch.ones_like(scale)
    codes = tops.wire_qsgd_unpack(words, ones, levels)
    j_codes = tops.wire_qsgd_unpack(torch.from_numpy(_bits(j_words).view(
        np.int32)), ones, levels)
    assert float((codes != j_codes).float().mean()) <= 1e-3
    dense = tops.wire_qsgd_unpack(words, scale, levels).numpy()
    want = np.asarray(JWF.qsgd_unpack_ref(j_words, j_scale, levels))
    assert np.all(np.abs(dense - want) <= 1.0001 * j_scale)


@pytest.mark.parametrize("use_kernel", (False, True))
def test_measured_bytes_equal_the_model(use_kernel):
    topk = TWF.make_wire_format("top_k", frac=0.25, use_kernel=use_kernel)
    qsgd = TWF.make_wire_format("qsgd", levels=7, use_kernel=use_kernel)
    dense_window = 4 * TWF.PACK_BLOCK
    assert dense_window / TWF.measured_pack_nbytes(topk, 2048) == 4.0
    assert dense_window / qsgd.payload_bytes(2048) == 8.0
    for d in (1, 2048, 2049, 50_890):
        for fmt, name, kw in ((topk, "top_k", dict(frac=0.25)),
                              (qsgd, "qsgd", dict(levels=7))):
            got = TWF.measured_pack_nbytes(fmt, d)
            assert got == fmt.buffer_bytes(d)
            assert got == JWF.measured_pack_nbytes(
                JWF.make_wire_format(name, **kw), d)


def test_wire_buffer_converters_round_trip():
    rows = _windows("ints", 4 * 2048 + 77, seed=16)
    key = jax.random.PRNGKey(16)
    buffers = (*_topk_pack_ref(jnp.asarray(rows), 102),
               *JWF.qsgd_pack_ref(key, jnp.asarray(rows), 16))
    tensors = convert.to_torch(buffers, "cpu")
    assert [t.dtype for t in tensors] == [torch.bfloat16, torch.int16,
                                          torch.int32, torch.float32]
    for back, want in zip(convert.wire_to_numpy(tensors), buffers):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert back.dtype == want.dtype
        np.testing.assert_array_equal(back, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rows = torch.zeros(2, 2048)
    with pytest.raises(ValueError, match="k must be"):
        tops.wire_topk_pack(rows, 0)
    with pytest.raises(ValueError, match="widths"):
        tops.wire_topk_pack(torch.zeros(2, 1000), 5)
    with pytest.raises(TypeError, match="takes"):
        tops.wire_topk_pack(rows.double(), 5)
    with pytest.raises(ValueError, match="levels"):
        tops.wire_qsgd_pack(rows, rows, 0)
    with pytest.raises(ValueError, match="noise"):
        TWF.make_wire_format("qsgd", levels=7).pack(rows)
    with pytest.raises(ValueError, match="no registered bit-packed"):
        TWF.make_wire_format("random_k", frac=0.1)
    assert all(v == 0 for v in tops.LAUNCHES.values())


# -- the CUDA topk_pack kernel's selection, emulated on the CPU -------------
#
# ``csrc/wire_pack.cu`` does not sweep the window once a bisection step.  In
# ``bisect_threshold`` the test count(|x| >= mid) >= k holds exactly when
# mid <= a_k, the k-th largest magnitude counted with multiplicity, so the
# 24 steps run on two scalars, max |x| and a_k; a_k comes from the radix
# select of ``csrc/radix_select.cuh`` (``radix_select_emulation``), and the
# first k elements with |x| >= lo are compacted in index order.  Every
# check is bitwise.
#
# Subnormal magnitudes: XLA on the CPU flushes f32 subnormals to zero (as a
# TPU does), so the reference's threshold is that of the flushed
# magnitudes; the port (PyTorch on the CPU, and the CUDA kernel) computes
# with them.  The tests hold the port to the identity on the magnitudes and
# the reference to the identity on the flushed ones (ROADMAP queue 3).

EDGE_KINDS = ("gauss", "ints", "sparse", "zeros", "negzero", "huge",
              "subnormal", "equal")
EDGE_KS = (1, 102, 512, 2048)
_TINY = np.finfo(np.float32).tiny


def _edge_windows(kind, seed):
    """Two f32 windows that stress the threshold: small-integer ties, fewer
    nonzeros than k, all zeros, -0.0 among zeros, one huge value (whose
    bisection overflows to inf in the reference too), subnormal magnitudes,
    one repeated value."""
    rng = np.random.default_rng(seed)
    shape = (2, 2048)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ints":
        x = rng.integers(-3, 4, shape).astype(np.float32)
    elif kind == "sparse":
        x = np.where(rng.random(shape) < 0.02, x, 0.0).astype(np.float32)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "negzero":
        x = np.where(rng.random(shape) < 0.5, np.float32(-0.0),
                     np.float32(0.0))
        x[:, 7] = 1.5
    elif kind == "huge":
        x[:, 100] = 3e38
    elif kind == "subnormal":
        x = (x * np.float32(1e-39)).astype(np.float32)
    elif kind == "equal":
        x = np.full(shape, -0.75, np.float32)
    return x


def _flushed(a):
    """Magnitudes as XLA on the CPU computes with them: subnormals as 0."""
    return np.where(a < _TINY, np.float32(0.0), a).astype(np.float32)


def _bisect_from_kth(top, a_k):
    """``N_BISECT_ITERS`` steps of the reference's bisection driven by the
    k-th largest magnitude: mid <= a_k stands for count(|x| >= mid) >= k."""
    lo, hi = np.float32(0.0), np.float32(top)
    with np.errstate(over="ignore"):
        for _ in range(TWF.N_BISECT_ITERS):
            mid = np.float32(np.float32(lo + hi) * np.float32(0.5))
            if mid <= a_k:
                lo = mid
            else:
                hi = mid
    return lo


def _from_kth(a, k):
    """The scalar bisection of each row of magnitudes ``a``, a_k from a
    sort."""
    return np.array([_bisect_from_kth(row.max(), np.sort(row)[::-1][k - 1])
                     for row in a], np.float32)


def _emulate_topk_pack(rows, k, flush=False):
    """The kernel's arithmetic: a_k by the radix select, the max, the
    scalar bisection, the compaction in index order (on flushed magnitudes
    with ``flush``).  Returns (bf16 bit patterns as uint16, int16 indices),
    each ``(nb, k)``."""
    raw, keys = RSE.keys(rows)
    if flush:
        keys = np.where(keys < _TINY.view(np.uint32), 0, keys)
    vals = np.zeros((rows.shape[0], k), np.uint16)
    idx = np.zeros((rows.shape[0], k), np.int16)
    for w, key in enumerate(keys):
        a_k = np.uint32(RSE.kth_key(key, k, 4)).view(np.float32)
        top = np.uint32(key.max()).view(np.float32)
        lo = _bisect_from_kth(top, a_k)
        keep = np.flatnonzero(key.astype(np.uint32).view(np.float32)
                              >= lo)[:k]
        vals[w] = _bits(np.asarray(jnp.asarray(rows[w, keep], jnp.bfloat16)))
        idx[w] = keep
    return vals, idx


@pytest.mark.parametrize("k", EDGE_KS)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_bisection_from_the_kth_magnitude_equals_bisect_threshold(kind, k):
    """The 24 scalar steps driven by a_k (from a sort) give the port's
    ``bisect_threshold`` bitwise, and the reference's on the magnitudes it
    computes with (the same ones unless subnormal)."""
    a = np.abs(_edge_windows(kind, seed=k + len(kind)))
    got = _from_kth(a, k)
    port = TWF.bisect_threshold(torch.from_numpy(a), k).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(port))
    want = jax.jit(jax.vmap(lambda r: JWF.bisect_threshold(r, k)))(a)
    np.testing.assert_array_equal(_bits(_from_kth(_flushed(a), k)),
                                  _bits(want))
    if kind != "subnormal":
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", EDGE_KS)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_kernel_topk_pack_emulation_equals_plain_and_reference(kind, k):
    """The emulated kernel (radix select, scalar bisection, index-order
    compaction) against the port's plain ``topk_pack_ref`` and, on the
    magnitudes the reference computes with, the reference's
    ``topk_pack_ref``, bitwise; the selected a_k is the k-th largest key
    of a sort."""
    rows = _edge_windows(kind, seed=k + 2 * len(kind))
    vals, idx = _emulate_topk_pack(rows, k)
    p_vals, p_idx = tops.wire_topk_pack(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(vals, _np(p_vals))
    np.testing.assert_array_equal(idx, _np(p_idx))
    j_vals, j_idx = _topk_pack_ref(jnp.asarray(rows), k)
    f_vals, f_idx = _emulate_topk_pack(rows, k, flush=True)
    np.testing.assert_array_equal(f_vals, _bits(j_vals))
    np.testing.assert_array_equal(f_idx.view(np.uint16), np.asarray(j_idx))
    if kind != "subnormal":
        np.testing.assert_array_equal(vals, f_vals)
        np.testing.assert_array_equal(idx, f_idx)
    _, keys = RSE.keys(rows)
    for key in keys:
        assert RSE.kth_key(key, k, 4) == np.sort(key)[::-1][k - 1]


# ---------------------------------------------------------------------------
# the qsgd_pack kernel's arithmetic (csrc/wire_pack.cu), emulated in numpy
# ---------------------------------------------------------------------------

QSGD_THREADS = 256
QSGD_KINDS = ("gauss", "cauchy", "scales", "subnormal", "zeros")


def _qsgd_rows(kind, rows=6, seed=0):
    """f32 windows for the norm: Gaussian, Cauchy (heavy tails), each
    element at its own scale from 1e-20 to 1e20, subnormal magnitudes or
    squares, all zero (and one -0.0)."""
    rng = np.random.default_rng(seed)
    shape = (rows, TWF.PACK_BLOCK)
    x = rng.standard_normal(shape)
    if kind == "cauchy":
        x = rng.standard_cauchy(shape)
    elif kind == "scales":    # the last row's squares overflow to inf
        x = x * 10.0 ** rng.uniform(-20, 16, shape)
        x[-1] = x[-1] * 1e4
    elif kind == "subnormal":   # subnormal values, and subnormal squares
        x = x * np.where(rng.random(shape) < 0.5, 1e-40, 2e-20)
    elif kind == "zeros":
        x = np.zeros(shape)
        x[0, 5] = -0.0
    return x.astype(np.float32)


def _emulate_qsgd_norm_sumsq(rows):
    """The kernel's one-barrier sum of squares: each thread's 8 squares in
    sequence, then every warp's lane l adds the 8 partials l + 32 j in the
    halving tree's order of its levels 128, 64, 32, then the shuffles 16
    ... 1 (a lane past the warp's end keeps its own value); lane 0's sum."""
    with np.errstate(over="ignore", invalid="ignore"):
        sq = rows * rows
        p = sq[:, 0::8].copy()
        for j in range(1, 8):
            p = p + sq[:, j::8]
        assert p.shape[1] == QSGD_THREADS
        c = [p[:, 32 * j:32 * j + 32] for j in range(8)]
        s = (((c[0] + c[4]) + (c[2] + c[6]))
             + ((c[1] + c[5]) + (c[3] + c[7])))
        for off in (16, 8, 4, 2, 1):
            down = np.concatenate([s[:, off:], s[:, 32 - off:]], axis=1)
            s = s + down
    return s[:, 0]


def _qsgd_route(epw):
    """Where the kernel joins a thread's 8 fields into words."""
    if 8 % epw == 0:
        return "registers"
    return "pair shuffle" if epw == 16 else "shared"


def _emulate_qsgd_pack(rows, noise, levels):
    """The kernel: the one-barrier norm, each element's field, then the
    words by the route its epw takes.  Returns (u32 words, f32 scales).
    The square root is correctly rounded, as the kernel's ``__fsqrt_rn``
    and the plain version's ``ref.sqrt_rn`` are (numpy's f32 ``sqrt`` is;
    PyTorch's CPU ``torch.sqrt`` can sit an ulp low)."""
    bits = TWF.qsgd_bits(levels)
    epw = TWF.qsgd_elems_per_word(levels)
    nwords = TWF.qsgd_words_per_window(levels)
    root = np.sqrt(_emulate_qsgd_norm_sumsq(rows))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        norm = (root + np.float32(1e-30))[:, None]
        y = (np.abs(rows) / norm) * np.float32(levels)
        lo = np.floor(y)
        code = lo + (noise < (y - lo)).astype(np.float32)
    f = code.astype(np.uint32) | ((rows < 0).astype(np.uint32)
                                  << np.uint32(bits - 1))
    nb = rows.shape[0]
    shift = (np.uint32(bits) * np.arange(32, dtype=np.uint32))
    route = _qsgd_route(epw)
    if route == "registers":      # thread t's 8 / epw whole words
        fe = f.reshape(nb, QSGD_THREADS, 8 // epw, epw)
        words = np.bitwise_or.reduce(fe << shift[:epw], axis=3)
        words = words.reshape(nb, nwords)
    elif route == "pair shuffle":  # two threads' halves of word t / 2
        half = np.bitwise_or.reduce(
            f.reshape(nb, QSGD_THREADS, 8) << shift[:8], axis=2)
        words = half[:, 0::2] | (half[:, 1::2] << np.uint32(bits * 8))
    else:                         # word i from the fields in shared memory
        pad = np.zeros((nb, nwords * epw), np.uint32)
        pad[:, :TWF.PACK_BLOCK] = f
        words = np.bitwise_or.reduce(
            pad.reshape(nb, nwords, epw) << shift[:epw], axis=2)
    denom = np.float32(TWF.qsgd_scale_denominator(levels))
    return words.astype(np.uint32), (norm / denom).astype(np.float32)


@pytest.mark.parametrize("kind", QSGD_KINDS)
def test_qsgd_pack_one_barrier_norm_equals_qsgd_sumsq(kind):
    """The pairing of the tree's first three levels across warps and the
    shuffle levels give ``ref.qsgd_sumsq`` (the halving tree) bitwise."""
    rows = _qsgd_rows(kind, seed=len(kind))
    want = tref.qsgd_sumsq(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(_bits(_emulate_qsgd_norm_sumsq(rows)),
                                  _bits(want))


def _qsgd_edge_rows(seed):
    """Gaussian windows, then the edges: all zero, one nonzero, all
    negative, all -0.0, subnormal magnitudes."""
    rows = _qsgd_rows("gauss", rows=8, seed=seed)
    rows[1] = 0.0
    rows[2] = 0.0
    rows[2, 1234] = -2.5
    rows[3] = -np.abs(rows[3])
    rows[4] = -0.0
    rows[5] = rows[5] * np.float32(1e-40)
    return rows


@pytest.mark.parametrize("bits", range(2, 17))
def test_qsgd_pack_word_routes_equal_plain(bits):
    """Every field width (epw = 32 / bits dividing 8: words built in
    registers; 16: two threads' halves joined by a shuffle; 10, 6, 5, 3:
    shared fields) at the largest and the smallest levels of that width,
    words and scales bitwise ``ref.qsgd_pack_ref``'s."""
    for levels in sorted({2 ** (bits - 1) - 1, max(1, 2 ** (bits - 2))}):
        assert TWF.qsgd_bits(levels) == bits
        rows = _qsgd_edge_rows(seed=bits + levels)
        noise = np.random.default_rng(levels).random(
            rows.shape).astype(np.float32)
        words, scale = _emulate_qsgd_pack(rows, noise, levels)
        p_words, p_scale = tref.qsgd_pack_ref(torch.from_numpy(rows),
                                              torch.from_numpy(noise), levels)
        np.testing.assert_array_equal(words, _np(p_words).view(np.uint32))
        np.testing.assert_array_equal(_bits(scale), _bits(p_scale.numpy()))
    assert _qsgd_route(32 // bits) == {
        2: "pair shuffle", 3: "shared", 4: "registers", 5: "shared",
        6: "shared", 7: "registers", 8: "registers", 9: "shared",
        10: "shared"}.get(bits, "registers")


# -- the qsgd_unpack kernel's thread layout, emulated in numpy --------------
#
# One CTA a window; thread t decodes and stores float4 t and t + 256, the
# runs of elements 4t ... 4t + 3 and 1024 + 4t ... 1024 + 4t + 3, from the
# words each run lies in: a quarter of one word (epw 16), half a word (8),
# one word (4), the uint2 of two words (2), or one or two scalar words (10,
# 6, 5, 3).

def _qsgd_unpack_reads(t, epw):
    """Thread t's two runs: for each, the words it reads and, for each of
    its 4 elements, (element, the word as an index into those, field)."""
    runs = []
    for e0 in (4 * t, TWF.PACK_BLOCK // 2 + 4 * t):
        first = e0 // epw
        s = e0 - first * epw
        if epw == 2:
            reads = [first, first + 1]
        elif epw % 4 == 0:
            reads = [first]
        else:
            reads = [first, first + 1] if s + 3 >= epw else [first]
        runs.append((reads, [(e0 + e, (s + e) // epw, (s + e) % epw)
                             for e in range(4)]))
    return runs


def _emulate_qsgd_unpack(words, scale, levels):
    """The kernel on u32 ``words`` ``(nb, W)`` and f32 ``scale``
    ``(nb, 1)``: each thread's reads and fields, then ``(sgn * code) *
    scale`` in f32."""
    bits = TWF.qsgd_bits(levels)
    epw = TWF.qsgd_elems_per_word(levels)
    field = np.zeros((words.shape[0], TWF.PACK_BLOCK), np.uint32)
    stored = []
    for t in range(QSGD_THREADS):
        for reads, fields in _qsgd_unpack_reads(t, epw):
            if epw == 2:         # one aligned uint2
                assert reads[0] % 2 == 0
            for el, i, pos in fields:
                assert reads[i] * epw + pos == el < TWF.PACK_BLOCK
                field[:, el] = words[:, reads[i]] >> np.uint32(bits * pos)
                stored.append(el)
    assert sorted(stored) == list(range(TWF.PACK_BLOCK))
    field &= np.uint32(2 ** bits - 1)
    code = (field & np.uint32(2 ** (bits - 1) - 1)).astype(np.float32)
    sgn = np.float32(1.0) - np.float32(2.0) * (
        field >> np.uint32(bits - 1)).astype(np.float32)
    return (sgn * code) * scale


def _unpack_words(levels, seed):
    """u32 words of three windows: random fields with every bit above the
    last field (and every padding field past element 2047) set, random
    words over all 32 bits, all-ones words (codes above ``levels``); and
    their f32 scales."""
    bits = TWF.qsgd_bits(levels)
    epw = TWF.qsgd_elems_per_word(levels)
    nwords = TWF.qsgd_words_per_window(levels)
    rng = np.random.default_rng(seed)
    fields = rng.integers(0, 2 ** bits, (nwords, epw), dtype=np.uint64)
    fields[-1, TWF.PACK_BLOCK - (nwords - 1) * epw:] = 2 ** bits - 1
    shift = (bits * np.arange(epw)).astype(np.uint64)
    high = np.uint64(0xFFFFFFFF) ^ np.uint64(2 ** (bits * epw) - 1)
    set_high = (np.bitwise_or.reduce(fields << shift, axis=1) | high)
    words = np.stack([set_high.astype(np.uint32),
                      rng.integers(0, 2 ** 32, nwords, dtype=np.uint64
                                   ).astype(np.uint32),
                      np.full(nwords, 0xFFFFFFFF, np.uint32)])
    scale = np.array([[0.0371], [1.0], [3.5e4]], np.float32)
    return words, scale


@pytest.mark.parametrize("bits", range(2, 17))
def test_qsgd_unpack_thread_layout_equals_plain_and_reference(bits):
    """Every field width at the largest and the smallest levels of that
    width: the emulated kernel bitwise ``ref.qsgd_unpack_ref``, the
    reference's ``qsgd_unpack_ref`` and the Pallas kernel (interpret
    mode), on words whose unused high bits are set and on all-ones
    words."""
    for levels in sorted({2 ** (bits - 1) - 1, max(1, 2 ** (bits - 2))}):
        assert TWF.qsgd_bits(levels) == bits
        words, scale = _unpack_words(levels, seed=bits + levels)
        got = _emulate_qsgd_unpack(words, scale, levels)
        plain = tref.qsgd_unpack_ref(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(scale), levels)
        np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
        j_words, j_scale = jnp.asarray(words), jnp.asarray(scale)
        np.testing.assert_array_equal(_bits(got), _bits(
            JWF.qsgd_unpack_ref(j_words, j_scale, levels)))
        np.testing.assert_array_equal(_bits(got), _bits(
            jops.wire_qsgd_unpack(j_words, j_scale, levels, interpret=True)))


# sums of squares whose f32 square root PyTorch's CPU ``torch.sqrt`` rounds
# one ulp low; the reference's (and the card's) is correctly rounded
MISROUNDED_SUMS = (267, 999, 1068, 1171, 1230, 1421, 1633)


@pytest.mark.parametrize("n", MISROUNDED_SUMS)
def test_qsgd_pack_on_a_misrounded_sum_is_the_reference(n):
    """A window of n ones: its sum of squares is n in any order, so the
    scale must be the reference's bit for bit (at 7 levels and at 16: at 7
    the quotient hides the misrounded root of 999); the Pallas kernel
    packs the same words, its scale within the 1 ulp of its reciprocal."""
    rows = np.zeros((2, TWF.PACK_BLOCK), np.float32)
    rows[0, :n] = 1.0
    rows[1, -n:] = -1.0
    key = jax.random.PRNGKey(0)
    for levels in (7, 16):
        words, scale = tops.wire_qsgd_pack(
            torch.from_numpy(rows),
            torch.from_numpy(_ref_uniforms(key, rows)), levels)
        j_words, j_scale = JWF.qsgd_pack_ref(key, jnp.asarray(rows), levels)
        np.testing.assert_array_equal(_np(words), np.asarray(j_words))
        np.testing.assert_array_equal(_bits(scale.numpy()), _bits(j_scale))
        p_words, p_scale = jops.wire_qsgd_pack(jnp.asarray(rows), key,
                                               levels, interpret=True)
        np.testing.assert_array_equal(_np(words), np.asarray(p_words))
        assert _ulps(scale.numpy(), p_scale).max() <= 1


def test_qsgd_pack_on_two_value_windows_is_the_reference():
    """Windows with two nonzero values: a sum of two squares, the same in
    any order, so words and scales are the reference's bit for bit; some of
    these sums are ones ``torch.sqrt`` misrounds."""
    rng = np.random.default_rng(17)
    nb = 2800
    rows = np.zeros((nb, TWF.PACK_BLOCK), np.float32)
    cols = np.stack([rng.choice(TWF.PACK_BLOCK, 2, replace=False)
                     for _ in range(nb)])
    vals = (rng.standard_normal((nb, 2))
            * 10.0 ** rng.uniform(-3, 3, (nb, 2))).astype(np.float32)
    np.put_along_axis(rows, cols, vals, axis=1)
    sums = tref.qsgd_sumsq(torch.from_numpy(rows))
    assert int((torch.sqrt(sums) != tref.sqrt_rn(sums)).sum()) >= 5
    key = jax.random.PRNGKey(3)
    words, scale = tops.wire_qsgd_pack(
        torch.from_numpy(rows), torch.from_numpy(_ref_uniforms(key, rows)),
        7)
    j_words, j_scale = JWF.qsgd_pack_ref(key, jnp.asarray(rows), 7)
    np.testing.assert_array_equal(_np(words), np.asarray(j_words))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(j_scale))
