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
  JAX chunked form stay at 1e-5 (both upcast to f32 first);
* 2e-5 normwise (max |error| / max |reference|) for an emulation of the
  CUDA kernel's bf16-part products against the JAX chunked form: 5x under
  the 1e-4 normwise gate ``chip_smoke.py`` holds the kernel to.
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


# -- the CUDA kernel's numeric plan, emulated on the CPU --------------------
#
# ``csrc/rwkv6_chunk.cu`` walks the 16-step chunks with the state kept
# transposed (S^T, value columns by key channels) in its mma accumulators.
# Per chunk it forms, in f32, la (the sequential cumsum, bitwise the plain
# version's), rq, kk, kend, p = r u k and the decay exp(la_end), and stores
# each as two bf16 parts (hi + lo).  Its products run as bf16 mma with f32
# accumulation: M = rq kk^T with hi.hi + hi.lo + lo.hi, of which the
# strictly lower entries are kept, its diagonal set to the bonus (p_hi +
# p_lo) times a vector of ones; o = M v (M split in two; v exact in bf16,
# or split in two and all four products taken) + rq S (both split, three
# products); S^T <- S^T diag(exp(la_end)) + v^T kend (kend split; v exact,
# or three products).  The emulation rounds with torch's bf16 cast (to
# nearest even, as the kernel's cvt.rn.bf16x2.f32) and sums in another
# order than the tensor cores; ``ftz`` flushes subnormal parts to zero, the
# other thing the tensor cores might do with them.  The tolerance, 2e-5
# normwise (max |emulated - reference| / max |reference|, for o and the
# state), leaves 5x to the kernel's 1e-4 gate on the card.

PLAN_TOL = 2e-5


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x, ftz):
    """x as two bf16 parts hi + lo (16 significant bits)."""
    hi = _bf16(x)
    lo = _bf16(x - hi)
    if ftz:
        hi, lo = (torch.where(p.abs() < 2.0 ** -126, 0.0, p) for p in (hi, lo))
    return hi, lo


def _product(a, b, ftz, a_exact=False, b_exact=False, four=False):
    """a @ b as the kernel forms it from bf16 parts of a and b: hi.hi +
    hi.lo + lo.hi, and lo.lo too with ``four``."""
    if a_exact:
        bh, bl = _split(b, ftz)
        return a @ bl + a @ bh
    if b_exact:
        ah, al = _split(a, ftz)
        return al @ b + ah @ b
    ah, al = _split(a, ftz)
    bh, bl = _split(b, ftz)
    if four:                                    # M v with f32 v
        return al @ bl + ah @ bl + al @ bh + ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def _emulate_kernel(r, k, v, logw, u, s0, ftz=False):
    """The kernel's arithmetic in plain PyTorch on the CPU."""
    s = r.shape[1]
    c = tref.RWKV_CHUNK
    exact = v.dtype == torch.bfloat16
    rs, ks, vs, lw = (t.to(torch.float32) for t in (r, k, v, logw))
    state = s0.to(torch.float32).transpose(-1, -2)          # S^T (b, h, j, n)
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool), diagonal=-1)
    diag = torch.eye(c, dtype=torch.bool)
    outs = []
    for c0 in range(0, s, c):
        rows = slice(c0, c0 + c)
        la = tref._cumsum_f32(lw[:, rows], dim=1)
        lend = la[:, -1:]
        rq = rs[:, rows] * torch.exp(la - lw[:, rows])
        kk = ks[:, rows] * torch.exp(-la)
        kend = ks[:, rows] * torch.exp(lend - la)
        p = rs[:, rows] * u.to(torch.float32) * ks[:, rows]
        rq, kk, kend, p, vc = (x.permute(0, 2, 1, 3)          # (b, h, t, n)
                               for x in (rq, kk, kend, p, vs[:, rows]))
        ph, pl = _split(p, ftz)
        bonus = pl.sum(-1) + ph.sum(-1)
        qk = _product(rq, kk.transpose(-1, -2), ftz)
        m = torch.where(strict, qk,
                        torch.where(diag, bonus[..., None], torch.zeros(())))
        o = (_product(m, vc, ftz, b_exact=exact, four=not exact)
             + _product(rq, state.transpose(-1, -2), ftz))
        outs.append(o.permute(0, 2, 1, 3))
        decay = torch.exp(lend[:, 0]).unsqueeze(-2)         # (b, h, 1, n)
        state = state * decay + _product(vc.transpose(-1, -2), kend, ftz,
                                         a_exact=exact)
    return torch.cat(outs, dim=1), state.transpose(-1, -2)


def _normwise(got, want):
    return [float(np.abs(g - np.asarray(w, np.float32)).max()
                  / np.abs(np.asarray(w, np.float32)).max())
            for g, w in zip(got, want)]


def _plan_case(shape, rkv, seed, clamp=False, ftz=False):
    dtype = jnp.bfloat16 if rkv == "bf16" else np.float32
    args = _inputs(*shape, seed=seed, rkvu_dtype=dtype)
    if clamp:   # log w at the model's clamp everywhere: |la| reaches 80
        args = args[:3] + (np.full_like(args[3], -5.0),) + args[4:]
    got = _emulate_kernel(*convert.to_torch(args, "cpu"), ftz=ftz)
    return _normwise(_np(got), _chunk_scan(*args))


# the serving head dim at a small B, S, H; every shape of SHAPES; N = 5 and
# 48 (widths padded to 16 and 64 on chip)
PLAN_SHAPES = ([(2, 128, 2, 64)] + SHAPES
               + [(1, 64, 2, 5), (2, 32, 3, 48)])


@pytest.mark.parametrize("rkv", ["bf16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids)
def test_kernel_numeric_plan_matches_the_jnp_chunked_form(shape, rkv):
    """The split-precision products at every shape, with bf16 and with f32
    r, k, v, within PLAN_TOL of the reference's ``_rwkv_chunk_scan``."""
    errs = _plan_case(shape, rkv, seed=sum(shape) + 4)
    assert max(errs) <= PLAN_TOL, errs


@pytest.mark.parametrize("ftz", [False, True], ids=["subnormals", "ftz"])
@pytest.mark.parametrize("rkv", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (1, 48, 3, 5)], ids=_ids)
def test_kernel_numeric_plan_holds_log_w_at_the_clamp(shape, rkv, ftz):
    """log w = -5 everywhere: rq falls to e^-75 |r| and kk grows to e^80
    |k|, so the second bf16 part of rq nears bf16's smallest normal; the
    plan holds whether the tensor cores keep or flush the subnormal
    parts."""
    errs = _plan_case(shape, rkv, seed=sum(shape) + 5, clamp=True, ftz=ftz)
    assert max(errs) <= PLAN_TOL, errs


@pytest.mark.parametrize("rkv", ["bf16", "f32"])
def test_kernel_numeric_plan_chains_state(rkv):
    """Two halves through the emulation with the carried state equal one
    pass, as the kernel's state-chaining check on the card."""
    dtype = jnp.bfloat16 if rkv == "bf16" else np.float32
    r, k, v, logw, u, s0 = convert.to_torch(
        _inputs(1, 96, 2, 64, seed=13, rkvu_dtype=dtype), "cpu")
    o, sf = _emulate_kernel(r, k, v, logw, u, s0)
    o1, sm = _emulate_kernel(r[:, :48], k[:, :48], v[:, :48], logw[:, :48],
                             u, s0)
    o2, sf2 = _emulate_kernel(r[:, 48:], k[:, 48:], v[:, 48:], logw[:, 48:],
                              u, sm)
    errs = _normwise(_np([torch.cat([o1, o2], 1), sf2]), _np([o, sf]))
    assert max(errs) <= PLAN_TOL, errs
