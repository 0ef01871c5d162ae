"""The port's RWKV6 chunked scan (``repro_torch.kernels.ops.rwkv6_scan``,
whose CPU path is the plain ``ref.rwkv6_chunk_ref``) against the JAX
package on the same inputs, made with numpy from a seed: the Pallas kernel
in interpret mode (``repro.kernels.ops.rwkv6_scan``), the jnp chunked form
(``repro.nn.ssm._rwkv_chunk_scan``) and the per-token recurrence
(``repro.kernels.ref.rwkv6_scan_ref``).

Tolerances (rtol = atol), each with its reason:

* 1e-5 against the chunked forms, JAX's and the Pallas kernel's: the same
  f32 algorithm, only the order of the sums differs (XLA's dots and
  cumsum against PyTorch's);
* 1e-4 against the recurrence, the reference's own tolerance
  (``tests/test_kernel_rwkv6.py``): the chunked form factorises the decay
  as exp(la_prev) * exp(-la), whose factors reach e^+-80, so its rounding
  differs from the recurrence's step-by-step products;
* 5e-2 for bf16 r, k, v, u against the f32 recurrence of the upcast
  inputs, as the reference's bf16 test; the same bf16 inputs through the
  JAX chunked form stay at 1e-5 (both upcast to f32 first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import ssm as jssm
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

_chunk_scan = jax.jit(jssm._rwkv_chunk_scan)
_recurrence = jax.jit(jref.rwkv6_scan_ref)

# (B, S, H, N): every value of B in {1, 3}, S in {16, 32, 64}, H in {1, 3}
# and N in {8, 16, 64} occurs, with S = 64 and N = 64 both at B = 3
SHAPES = [(1, 16, 1, 8), (3, 16, 3, 16), (1, 32, 3, 64), (3, 32, 1, 8),
          (1, 64, 1, 16), (3, 64, 3, 8), (3, 64, 1, 64), (1, 16, 3, 64),
          (3, 32, 3, 16), (1, 64, 3, 8)]


def _ids(shape):
    return "B{}-S{}-H{}-N{}".format(*shape)


def _inputs(b, s, h, n, seed, rkvu_dtype=np.float32):
    """numpy inputs of the reference's test: normal r, k, v, u and s0,
    log w uniform in [-4.9, -0.01]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(0.01, 4.9, (b, s, h, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    if rkvu_dtype != np.float32:
        r, k, v, u = (np.asarray(jnp.asarray(x, rkvu_dtype))
                      for x in (r, k, v, u))
    return r, k, v, logw, u, s0


def _port(*arrays):
    return tops.rwkv6_scan(*convert.to_torch(arrays, "cpu"))


def _np(tensors):
    return [np.asarray(t, np.float32) for t in convert.to_numpy(tensors)]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_jnp_chunked_form(shape):
    args = _inputs(*shape, seed=sum(shape))
    _close(_np(_port(*args)), _chunk_scan(*args), 1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_pallas_kernel_in_interpret_mode(shape):
    args = _inputs(*shape, seed=sum(shape) + 1)
    want = jops.rwkv6_scan(*args, interpret=True)
    _close(_np(_port(*args)), want, 1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_recurrence(shape):
    args = _inputs(*shape, seed=sum(shape) + 2)
    _close(_np(_port(*args)), _recurrence(*args), 1e-4)


def test_bf16_inputs():
    """bf16 r, k, v and u, as the serving path passes r, k, v."""
    args = _inputs(2, 32, 2, 16, seed=5, rkvu_dtype=jnp.bfloat16)
    got = _np(_port(*args))
    assert all(t.dtype == torch.float32 for t in _port(*args))
    _close(got, _chunk_scan(*args), 1e-5)
    up = [np.asarray(jnp.asarray(x, jnp.float32)) for x in args]
    _close(got[:1], _recurrence(*up)[:1], 5e-2)
    _close(got, jops.rwkv6_scan(*args, interpret=True), 1e-5)


def test_state_chaining():
    """Two halves with the carried state equal one pass."""
    r, k, v, logw, u, s0 = convert.to_torch(_inputs(1, 64, 2, 8, seed=3),
                                            "cpu")
    o_full, sf_full = tops.rwkv6_scan(r, k, v, logw, u, s0)
    half = 32
    o1, s_mid = tops.rwkv6_scan(r[:, :half], k[:, :half], v[:, :half],
                                logw[:, :half], u, s0)
    o2, sf2 = tops.rwkv6_scan(r[:, half:], k[:, half:], v[:, half:],
                              logw[:, half:], u, s_mid)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(sf2, sf_full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 48, 3, 8), (1, 16, 2, 64)], ids=_ids)
def test_plain_chunked_form_equals_the_plain_recurrence(shape):
    """Inside the port: ``rwkv6_chunk_ref`` against ``rwkv6_scan_ref`` at
    the reference's 1e-4."""
    args = convert.to_torch(_inputs(*shape, seed=11), "cpu")
    for got, want in zip(tref.rwkv6_chunk_ref(*args),
                         tref.rwkv6_scan_ref(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrapper_checks_and_counts_no_cpu_launch():
    r, k, v, logw, u, s0 = convert.to_torch(_inputs(1, 32, 2, 8, seed=0),
                                            "cpu")
    tops.reset_launches()
    tops.rwkv6_scan(r, k, v, logw, u, s0)
    assert tops.LAUNCHES["rwkv6_chunk"] == 0
    with pytest.raises(ValueError, match="multiple of 16"):
        tops.rwkv6_scan(r[:, :24], k[:, :24], v[:, :24], logw[:, :24], u, s0)
    with pytest.raises(ValueError, match="shape"):
        tops.rwkv6_scan(r, k, v, logw, u[:1], s0)
    with pytest.raises(ValueError, match="shape"):
        tops.rwkv6_scan(r, k, v, logw, u, s0[:, :1])
    with pytest.raises(ValueError, match=r"\(B, S, H, N\)"):
        tops.rwkv6_scan(r[0], k[0], v[0], logw[0], u, s0)
