"""The ``block_topk`` kernel's wrapper and the ``block_top_k`` compressor
against the JAX reference on the CPU.

On the CPU ``ops.block_topk`` runs the kernel's plain version, the stable
sort that keeps exactly k per 2048-window with ties to the lower index;
``chip_smoke.py`` holds the CUDA kernel bitwise against it on the card.
Every check here is bitwise (uint32 / uint16 patterns, so a kept -0.0 must
stay -0.0): a selection and a copy.

* against ``repro.kernels.ref.block_topk_ref`` (``jax.lax.top_k``) and the
  reference compressor ``repro.core.compression.block_top_k``, with
  Gaussian, integer-valued (ties), all-zero and -0.0 windows;
* against the Pallas kernel in interpret mode on tie-free Gaussian rows;
* on exact ties the Pallas kernel keeps more than k (everything at or
  above its bisection threshold), the port exactly k;
* an emulation of the CUDA kernel's selection (``_radix_select``: a digit
  at a time from 256-bin histograms, stopping once every key that shares
  the digits found is kept, ties ranked in index order) against both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JCMP
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch import convert
from repro_torch.core import compression as TCMP
from repro_torch.kernels import ops, ref

import radix_select_emulation as RSE

torch.set_num_threads(1)

BLOCK = 2048
LENGTHS = [1, 2047, 2048, 3 * 2048 + 17]
KS = [1, 102, 512, 2048]


def _row(kind, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return rng.standard_normal(d).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, d).astype(np.float32)
    x = np.zeros(d, np.float32)
    if kind == "negzero":
        x[::3] = -0.0
        x[d // 2] = 1.5
    return x


def _windows(x):
    pad = (-x.shape[0]) % BLOCK
    return np.pad(x, (0, pad)).reshape(-1, BLOCK)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


@pytest.mark.parametrize("kind", ["gauss", "ties", "zeros", "negzero"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", LENGTHS)
def test_block_topk_equals_reference(d, k, kind):
    x = _row(kind, d, seed=d + k)
    win = _windows(x)
    got = ops.block_topk(torch.from_numpy(win), k).numpy()
    want = np.asarray(JR.block_topk_ref(jnp.asarray(win), k))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert ((got != 0) | np.signbit(got)).sum(1).max() <= k
    # the compressor (one row, padded to whole windows) is the same
    # selection as the reference's
    frac = k / BLOCK
    got_c = TCMP.block_top_k(frac)(None, torch.from_numpy(x)[None])[0]
    want_c = JCMP.block_top_k(frac).fn(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_array_equal(_bits(got_c.numpy()), _bits(want_c))


@pytest.mark.parametrize("kind", ["gauss", "ties"])
@pytest.mark.parametrize("k", [1, 102, 2048])
def test_block_topk_in_bf16_equals_reference(k, kind):
    x = jnp.asarray(_windows(_row(kind, 3 * BLOCK, seed=k))).astype(
        jnp.bfloat16)
    got = ops.block_topk(convert.to_torch(np.asarray(x), "cpu"), k)
    assert got.dtype == torch.bfloat16
    want = JR.block_topk_ref(x, k)
    np.testing.assert_array_equal(convert.to_numpy(got), _bits(want))


@pytest.mark.parametrize("frac", [1 / BLOCK, 0.05, 0.25])
def test_block_topk_equals_pallas_kernel_on_tie_free_rows(frac):
    x = _row("gauss", 4 * BLOCK + 300, seed=int(frac * 1e4))
    want = JO.block_topk(jnp.asarray(x), frac, interpret=True)
    k = max(int(round(frac * BLOCK)), 1)
    got = ops.block_topk(torch.from_numpy(_windows(x)), k).numpy()
    np.testing.assert_array_equal(_bits(got.reshape(-1)[:x.shape[0]]),
                                  _bits(want))


def test_pallas_kernel_keeps_more_than_k_on_ties_the_port_exactly_k():
    """Integer-valued windows: the k-th magnitude is tied many times.  The
    TPU kernel keeps every element at or above its threshold; its own
    oracle, the reference compressor and the port keep exactly k, ties to
    the lower index."""
    x = _row("ties", 2 * BLOCK, seed=3)
    k = 102
    pallas = np.asarray(JO.block_topk(jnp.asarray(x), k / BLOCK,
                                      interpret=True)).reshape(-1, BLOCK)
    got = ops.block_topk(torch.from_numpy(_windows(x)), k).numpy()
    assert ((pallas != 0).sum(1) > k).all()
    assert ((got != 0).sum(1) == k).all()
    np.testing.assert_array_equal(
        got, np.asarray(JR.block_topk_ref(jnp.asarray(_windows(x)), k)))
    # the port's kept set is the first k in index order among the ties
    kept = np.nonzero(got[0])[0]
    top = np.abs(x[:BLOCK]).max()
    assert (np.abs(got[0][kept]) == top).all()
    assert np.array_equal(kept, np.nonzero(np.abs(x[:BLOCK]) == top)[0][:k])


@pytest.mark.parametrize("call,match", [
    (lambda: ops.block_topk(torch.zeros(2, BLOCK), 0), "k must be"),
    (lambda: ops.block_topk(torch.zeros(2, BLOCK), BLOCK + 1), "k must be"),
    (lambda: ops.block_topk(torch.zeros(2, 1024), 5), "rows"),
    (lambda: ops.block_topk(torch.zeros(2, BLOCK, dtype=torch.float64), 5),
     "f32 or bf16"),
])
def test_block_topk_refuses_what_the_kernel_does_not_take(call, match):
    with pytest.raises((ValueError, TypeError), match=match):
        call()


def test_top_k_keeps_the_whole_row_sort():
    """``top_k`` selects over the whole row (not the kernel's windows)
    with the same stable-sort selection."""
    x = torch.from_numpy(_row("ties", 3000, seed=4))[None]
    got = TCMP.top_k(0.05)(None, x)
    want = JCMP.top_k(0.05).fn(jax.random.PRNGKey(0), jnp.asarray(x[0].numpy()))
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want))
    assert torch.equal(got, ref.block_topk_ref(x, 150))


# -- the CUDA kernel's selection, emulated on the CPU ------------------------
#
# ``csrc/block_topk.cu`` finds the k-th largest key with the radix select of
# ``csrc/radix_select.cuh`` (emulated in ``radix_select_emulation``: a digit
# at a time from 256-bin histograms, stopping once every key that shares
# the digits found is kept); else the ties at the k-th key are ranked in
# index order.

_radix_select = RSE.radix_select


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["gauss", "ties", "zeros", "negzero"])
@pytest.mark.parametrize("k", KS)
def test_kernel_selection_equals_reference(k, kind, dt):
    """The emulated radix select, bitwise, against the port's plain version
    and the reference's oracle and compressor, in f32 and bf16."""
    win = _windows(_row(kind, 3 * BLOCK + 17, seed=k + 7))
    if dt == "bf16":
        win = np.asarray(jnp.asarray(win).astype(jnp.bfloat16))
    got = _radix_select(win, k)
    assert ((got != 0) | np.signbit(got.astype(np.float32))).sum(1).max() <= k
    np.testing.assert_array_equal(_bits(got),
                                  _bits(JR.block_topk_ref(jnp.asarray(win), k)))
    want = ref.block_topk_ref(convert.to_torch(win, "cpu"), k)
    np.testing.assert_array_equal(_bits(got), convert.to_numpy(want)
                                  if dt == "bf16" else _bits(want.numpy()))
    if dt == "f32":
        row = win.reshape(-1)
        comp = JCMP.block_top_k(k / BLOCK).fn(jax.random.PRNGKey(0),
                                              jnp.asarray(row))
        np.testing.assert_array_equal(_bits(got.reshape(-1)), _bits(comp))


def test_kernel_selection_stops_early_and_ranks_ties():
    """The two ends of the selection: a Gaussian window whose kept set is
    fixed after the first digits, and an integer window whose k-th
    magnitude is tied many times (every pass runs, ties by index)."""
    gauss = _windows(_row("gauss", BLOCK, seed=1))
    ties = _windows(_row("ties", BLOCK, seed=2))
    passes = []
    for win in (gauss, ties):
        np.testing.assert_array_equal(
            _bits(_radix_select(win, 102, passes)),
            _bits(JR.block_topk_ref(jnp.asarray(win), 102)))
    assert passes[0] < 4 and passes[1] == 4
    kept = np.flatnonzero(_radix_select(ties, 102)[0])
    top = np.abs(ties[0]).max()
    assert np.array_equal(kept, np.flatnonzero(np.abs(ties[0]) == top)[:102])
