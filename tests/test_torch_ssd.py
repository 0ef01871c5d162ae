"""The port's Mamba2 SSD chunked scan (``repro_torch.kernels.ops.ssd_scan``,
whose CPU path is the plain ``ref.ssd_chunk_ref``) against the JAX package
on the same inputs, made with numpy from a seed: the Pallas kernel in
interpret mode (``repro.kernels.ops.ssd_scan``), the jnp chunked form
(``repro.nn.ssm._ssd_chunk_scan``) and the per-token recurrence
(``repro.nn.ssm.ssd_scan_ref``).

Every comparison is normwise: max |port - reference| <= tol * max
|reference| over each output.  A reordered f32 sum errs relative to the
size of its terms, not of its result, so an element near zero carries the
error of its O(10) neighbours (at P = N = 64 an elementwise 1e-5 fails on
9 of 16,384 elements at 2.9e-5, while the normwise error is 7e-7).  The
tolerances, each with its reason:

* 1e-5 against the jnp chunked form: the same f32 algorithm with the same
  sequential f32 cumsum; only the order of the einsums' sums differs;
* 1e-4 against the Pallas kernel (the reference's own tolerance for it,
  ``tests/test_kernel_ssd.py``): it sums its products in another order and
  takes B / C per head through a broadcast;
* 1e-4 against the recurrence, the reference's own tolerance: the chunked
  form multiplies decays exp(la_t - la_s) that the recurrence forms step by
  step;
* bf16 B / C (the serving path's dtype): the same tolerances, since every
  form upcasts them to f32 before any arithmetic;
* 1e-4 for the emulation of the CUDA kernel's split-precision products
  (``_emulate_kernel``; the gate ``chip_smoke.py`` holds the kernel to on
  the card): bf16 products with f32 operands split into bf16 parts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.nn import ssm as jssm
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.nn import ssm as tssm

torch.set_num_threads(1)

_chunk_scan = jax.jit(jssm._ssd_chunk_scan)
_recurrence = jax.jit(jssm.ssd_scan_ref)

# (B, S, H, P, N): S a multiple of 64 (the chunk), P and N as the
# reference's kernel test draws them, plus the serving path's P = N = 64
SHAPES = [(1, 64, 1, 4, 8), (2, 128, 3, 8, 16), (1, 128, 2, 16, 8),
          (2, 64, 2, 64, 64), (1, 192, 1, 8, 8)]


def _ids(shape):
    return "B{}-S{}-H{}-P{}-N{}".format(*shape)


def _inputs(b, s, h, p, n, seed, bc_dtype=np.float32):
    """numpy inputs of the reference's test: normal xh, B, C and h0, dla
    uniform in [-0.5, -0.01]."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dla = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    if bc_dtype != np.float32:
        bm, cm = (np.asarray(jnp.asarray(x, bc_dtype)) for x in (bm, cm))
    return xh, bm, cm, dla, h0


def _port(*arrays):
    return tops.ssd_scan(*convert.to_torch(arrays, "cpu"))


def _np(tensors):
    return [np.asarray(t, np.float32) for t in convert.to_numpy(tensors)]


def _close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_jnp_chunked_form(shape):
    """``ops.ssd_scan`` and the model's ``nn.ssm._ssd_chunk_scan`` against
    the reference's ``_ssd_chunk_scan``."""
    args = _inputs(*shape, seed=sum(shape))
    got = _port(*args)
    assert [tuple(t.shape) for t in got] == [shape[:4],
                                             shape[:1] + shape[2:]]
    assert all(t.dtype == torch.float32 for t in got)
    want = _chunk_scan(*args)
    _close(_np(got), want, 1e-5)
    _close(_np(tssm._ssd_chunk_scan(*convert.to_torch(args, "cpu"))), want,
           1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_pallas_kernel_in_interpret_mode(shape):
    args = _inputs(*shape, seed=sum(shape) + 1)
    want = jops.ssd_scan(*args, interpret=True)
    _close(_np(_port(*args)), want, 1e-4)
    _close(_np(tref.ssd_chunk_ref(*convert.to_torch(args, "cpu"))), want,
           1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scan_matches_the_recurrence(shape):
    args = _inputs(*shape, seed=sum(shape) + 2)
    want = _recurrence(*args)
    _close(_np(_port(*args)), want, 1e-4)
    # the port's own recurrence (the decode path) against the reference's
    _close(_np(tref.ssd_scan_ref(*convert.to_torch(args, "cpu"))), want,
           1e-5)


@pytest.mark.parametrize("bc", ["bf16", "f32"])
def test_bc_dtypes(bc):
    """B and C in bf16 (the serving path's activations) or f32."""
    dtype = jnp.bfloat16 if bc == "bf16" else np.float32
    args = _inputs(2, 128, 2, 16, 16, seed=5, bc_dtype=dtype)
    got = _port(*args)
    assert got[0].dtype == got[1].dtype == torch.float32
    _close(_np(got), _chunk_scan(*args), 1e-5)
    _close(_np(got), jops.ssd_scan(*args, interpret=True), 1e-4)
    _close(_np(got), _recurrence(*args), 1e-4)


def test_state_chaining():
    """Two halves with the carried state equal one pass, as the
    reference's ``test_ssd_kernel_state_chaining``."""
    xh, bm, cm, dla, h0 = convert.to_torch(_inputs(1, 128, 2, 4, 8, seed=7),
                                           "cpu")
    y_full, hf_full = tops.ssd_scan(xh, bm, cm, dla, h0)
    y1, hm = tops.ssd_scan(xh[:, :64], bm[:, :64], cm[:, :64], dla[:, :64],
                           h0)
    y2, hf2 = tops.ssd_scan(xh[:, 64:], bm[:, 64:], cm[:, 64:], dla[:, 64:],
                            hm)
    _close(_np([torch.cat([y1, y2], 1), hf2]), _np([y_full, hf_full]), 1e-4)


def test_column_slices_are_read_in_place():
    """B and C as column slices of one activation, as ``mamba2_block``
    passes them, give the same result as contiguous copies."""
    xh, bm, cm, dla, h0 = convert.to_torch(_inputs(2, 64, 2, 8, 8, seed=9),
                                           "cpu")
    xbc = torch.cat([torch.ones(2, 64, 3), bm, cm], dim=-1)
    got = tops.ssd_scan(xh, xbc[..., 3:11], xbc[..., 11:], dla, h0)
    want = tops.ssd_scan(xh, bm, cm, dla, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_checks_and_counts_no_cpu_launch():
    xh, bm, cm, dla, h0 = convert.to_torch(_inputs(1, 64, 2, 4, 8, seed=0),
                                           "cpu")
    tops.reset_launches()
    tops.ssd_scan(xh, bm, cm, dla, h0)
    assert tops.LAUNCHES["ssd_chunk"] == 0
    with pytest.raises(ValueError, match="multiple of 64"):
        tops.ssd_scan(xh[:, :32], bm[:, :32], cm[:, :32], dla[:, :32], h0)
    with pytest.raises(ValueError, match="multiple of 64"):
        tops.ssd_scan(torch.cat([xh, xh[:, :8]], 1),
                      torch.cat([bm, bm[:, :8]], 1),
                      torch.cat([cm, cm[:, :8]], 1),
                      torch.cat([dla, dla[:, :8]], 1), h0)
    with pytest.raises(ValueError, match="shape"):
        tops.ssd_scan(xh, bm, cm[..., :4], dla, h0)
    with pytest.raises(ValueError, match="shape"):
        tops.ssd_scan(xh, bm, cm, dla[..., :1], h0)
    with pytest.raises(ValueError, match="shape"):
        tops.ssd_scan(xh, bm, cm, dla, h0[:, :, :2])
    with pytest.raises(ValueError, match=r"\(B, S, H, P\)"):
        tops.ssd_scan(xh[0], bm, cm, dla, h0)


# -- the CUDA kernel's numeric plan, emulated on the CPU --------------------
#
# ``csrc/ssd_chunk.cu`` walks each 64-step chunk in four 16-row blocks, the
# state passed from block to block, with la the chunk's sequential f32
# cumsum (bitwise the plain version's).  Its products run as bf16 mma with
# f32 accumulation: C h^T and (xh * kend)^T B with the f32 operand split
# into two bf16 parts (hi + lo, 16 significant bits), C B^T exact when B / C
# are bf16, and with f32 B / C those split too (hi.hi + hi.lo + lo.hi);
# M xh with both operands split into three bf16 parts (24 significant
# bits) and the six products whose order is at most 2^-16.  The emulation
# rounds with torch's bf16 cast (to nearest even, as the kernel's
# cvt.rn.bf16x2.f32) and sums in another order than the tensor cores.


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, n):
    """x as n bf16 parts whose sum carries 8 n significant bits."""
    out = []
    for _ in range(n - 1):
        hi = _bf16(x)
        out.append(hi)
        x = x - hi
    return out + [_bf16(x)]


def _product(a, b, a_exact, b_exact, three=False):
    """a @ b as the kernel forms it from bf16 parts of a and b."""
    if three:                                   # M xh
        a1, a2, a3 = _parts(a, 3)
        b1, b2, b3 = _parts(b, 3)
        return (a3 @ b1 + a1 @ b3 + a2 @ b2) + (a2 @ b1 + a1 @ b2) + a1 @ b1
    if a_exact and b_exact:                     # C B^T, bf16 B / C
        return a @ b
    if b_exact:                                 # (xh kend)^T B, bf16 B
        ah, al = _parts(a, 2)
        return al @ b + ah @ b
    ah, al = _parts(a, 2)
    bh, bl = _parts(b, 2)
    if a_exact:                                 # C h^T, bf16 C
        return ah @ bl + ah @ bh
    return ah @ bl + al @ bh + ah @ bh          # either with f32 B / C


def _emulate_kernel(xh, bmat, cmat, dla, h0):
    """The kernel's arithmetic in plain PyTorch on the CPU."""
    b, s, h, p = xh.shape
    exact = bmat.dtype == torch.bfloat16
    xs, bs, cs = (t.to(torch.float32) for t in (xh, bmat, cmat))
    state = h0.to(torch.float32)
    ys = []
    tri = torch.tril(torch.ones(16, 16, dtype=torch.bool))
    zero = torch.zeros(())
    for c0 in range(0, s, tref.SSD_CHUNK):
        la = tref._cumsum_f32(dla[:, c0:c0 + tref.SSD_CHUNK].float(), dim=1)
        for g0 in range(0, tref.SSD_CHUNK, 16):
            rows = slice(c0 + g0, c0 + g0 + 16)
            cg, bg = cs[:, rows], bs[:, rows]                   # (b, 16, n)
            xg = xs[:, rows].permute(0, 2, 1, 3)                # (b, h, 16, p)
            lg = la[:, g0:g0 + 16].permute(0, 2, 1)             # (b, h, 16)
            base = la[:, g0 - 1].unsqueeze(-1) if g0 else torch.zeros(())
            lend = lg[..., -1:]
            y = torch.exp(lg - base)[..., None] * _product(
                cg[:, None], state.transpose(-1, -2), exact, False)
            cb = _product(cg, bg.transpose(-1, -2), exact, exact)[:, None]
            dmat = lg[..., :, None] - lg[..., None, :]
            m = torch.where(tri, cb * torch.exp(torch.where(tri, dmat, zero)),
                            zero)
            y = y + _product(m, xg, False, False, three=True)
            ys.append(y.permute(0, 2, 1, 3))
            a = (xg * torch.exp(lend - lg)[..., None]).transpose(-1, -2)
            state = (state * torch.exp(lend - base)[..., None]
                     + _product(a, bg[:, None], False, exact))
    return torch.cat(ys, dim=1), state


@pytest.mark.parametrize("bc", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 128, 2, 64, 64)] + SHAPES, ids=_ids)
def test_kernel_numeric_plan_matches_the_jnp_chunked_form(shape, bc):
    """The split-precision products at the serving P = N = 64 (small B, S,
    H) and at each (P, N) of ``SHAPES``, in both B / C dtypes, within the
    kernel's gate of the reference's ``_ssd_chunk_scan``."""
    dtype = jnp.bfloat16 if bc == "bf16" else np.float32
    args = _inputs(*shape, seed=sum(shape) + 3, bc_dtype=dtype)
    got = _emulate_kernel(*convert.to_torch(args, "cpu"))
    _close(_np(got), _chunk_scan(*args), 1e-4)


def test_kernel_numeric_plan_chains_state():
    """Two halves through the emulation with the carried state equal one
    pass, as the kernel's state chaining check on the card."""
    xh, bm, cm, dla, h0 = convert.to_torch(
        _inputs(1, 256, 2, 64, 64, seed=11, bc_dtype=jnp.bfloat16), "cpu")
    y, hf = _emulate_kernel(xh, bm, cm, dla, h0)
    y1, hm = _emulate_kernel(xh[:, :128], bm[:, :128], cm[:, :128],
                             dla[:, :128], h0)
    y2, hf2 = _emulate_kernel(xh[:, 128:], bm[:, 128:], cm[:, 128:],
                              dla[:, 128:], hm)
    _close(_np([torch.cat([y1, y2], 1), hf2]), _np([y, hf]), 1e-4)
