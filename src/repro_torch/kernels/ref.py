"""Plain PyTorch versions of the fused kernels.

They are the CPU path of :mod:`repro_torch.kernels.ops`, and the versions
the CUDA kernels are held against on the card (``chip_smoke.py``): bitwise,
except the RWKV6 and SSD scans, which are held at a stated tolerance.
Each keeps the reference's order of operations
(``src/repro/kernels/ef_update.py``, ``src/repro/kernels/sr_cast.py``, the
wire codecs of ``src/repro/core/wire_formats.py``): f32 arithmetic, one op
at a time, so no step is fused into an FMA.  The wire codecs take their
random operand explicitly (qsgd's U[0, 1) ``noise``), and their layout from
:mod:`repro_torch.core.wire_formats`, which re-exports them.

The clip pair (``clip_sumsq``, ``clip_scale_ref``) and ``smooth_clip_ref``
copy Definition 2 of ``src/repro/kernels/smooth_clip.py`` and
``src/repro/kernels/ref.py:10``; ``sample_mean`` and ``dp_mean_noise_ref``
the mean of the clipped samples as the reference's jitted
``clipped_grad_accumulate`` takes it (``src/repro/core/clipping.py:101-104``)
and its DP perturbation; ``block_topk_ref`` is the exact-k window
selection of ``src/repro/kernels/ref.py:20`` and of the reference's
``block_top_k`` compressor.

The RWKV6 pair (``rwkv6_chunk_ref``, ``rwkv6_scan_ref``) and the Mamba2
SSD pair (``ssd_chunk_ref``, ``ssd_scan_ref``) copy the chunked forms and
the per-token recurrences of ``src/repro/nn/ssm.py``, all in f32.

``out_dtype`` (the ef updates): ``None`` writes each output in its state
operand's dtype; a dtype (the engine asks for f32) writes all three in it,
for the stochastic-rounding writeback to take over.
"""

from __future__ import annotations

import torch

__all__ = ["ef_track_ref", "ef_step_ref", "ef_gossip_ref", "sr_cast_ref",
           "sqrt_rn", "clip_sumsq", "clip_scale_ref", "smooth_factors",
           "clip_planes_ref", "smooth_clip_ref", "sample_mean",
           "dp_mean_noise_ref",
           "block_topk_ref",
           "topk_pack_ref", "topk_unpack_ref", "qsgd_pack_ref",
           "qsgd_unpack_ref", "qsgd_sumsq", "rwkv6_chunk_ref",
           "rwkv6_scan_ref", "ssd_chunk_ref", "ssd_scan_ref", "RWKV_CHUNK",
           "SSD_CHUNK"]

_F32 = torch.float32

# the RWKV6 scan's chunk length (``repro.nn.ssm.RWKV_CHUNK``): the
# kernel (``csrc/rwkv6_chunk.cu``'s kC), the wrapper and the model read
# it from here
RWKV_CHUNK = 16
# the SSD scan's chunk length (``repro.nn.ssm.SSD_CHUNK``), read from here
# by ``csrc/ssd_chunk.cu``'s kC, the wrapper and the model alike
SSD_CHUNK = 64


def _outs(states, values, out_dtype):
    return tuple(v.to(s.dtype if out_dtype is None else out_dtype)
                 for s, v in zip(states, values))


def ef_track_ref(q, m, v, c, wc, g, gp, gamma: float, out_dtype=None):
    q2 = q.to(_F32) + c.to(_F32)
    m2 = m.to(_F32) + wc.to(_F32)
    v2 = v.to(_F32) + gamma * (m2 - q2) + g.to(_F32) - gp.to(_F32)
    return _outs((q, m, v), (q2, m2, v2), out_dtype)


def ef_step_ref(q, m, x, c, wc, v, gamma: float, eta: float, out_dtype=None):
    q2 = q.to(_F32) + c.to(_F32)
    m2 = m.to(_F32) + wc.to(_F32)
    x2 = x.to(_F32) + gamma * (m2 - q2) - eta * v.to(_F32)
    return _outs((q, m, x), (q2, m2, x2), out_dtype)


def ef_gossip_ref(q, m, y, c, wc, gamma: float, scale: float = 1.0,
                  out_dtype=None):
    q2 = q.to(_F32) + scale * c.to(_F32)
    m2 = m.to(_F32) + scale * wc.to(_F32)
    y2 = y.to(_F32) + gamma * (m2 - q2)
    return _outs((q, m, y), (q2, m2, y2), out_dtype)


def sr_cast_ref(x, bits):
    """Stochastic rounding f32 -> bf16: ``high16(bits(x) + (r & 0xFFFF))``.

    ``bits``: int32 of ``x``'s shape (the reference's u32 words, same bit
    patterns); only the low 16 bits are read.  The sum is formed in int32,
    whose two's-complement wrap is the reference's mod-2^32 arithmetic; the
    arithmetic shift then leaves the same low 16 bits as a logical one, and
    they fit int16 exactly, so ``.view(bfloat16)`` gives the reference's
    bits.
    """
    if x.shape != bits.shape:
        raise ValueError(f"sr_cast shape mismatch: {tuple(x.shape)} vs "
                         f"{tuple(bits.shape)}")
    word = x.to(_F32).contiguous().view(torch.int32) + (bits & 0xFFFF)
    return (word >> 16).to(torch.int16).view(torch.bfloat16)


def sqrt_rn(s):
    """The correctly rounded f32 square root of an f32 tensor, as XLA and
    the card's ``sqrtf`` / ``__fsqrt_rn`` give it: PyTorch's CPU
    ``torch.sqrt`` of an f32 can sit an ulp low (``sqrt(267.0)``).  Taken
    in f64 and rounded once to f32; 53 >= 2 * 24 + 2 bits make that double
    rounding harmless for a square root."""
    return torch.sqrt(s.double()).float()


def clip_sumsq(planes):
    """Per-tile sum of squares of a ``(tiles, TILE)`` plane of any float
    dtype, in f32 and in the kernel's fixed order (:func:`qsgd_sumsq`'s,
    at 1024 partials of 8) -> ``(tiles,)`` f32."""
    return qsgd_sumsq(planes.to(_F32))


def clip_scale_ref(planes, factor, noise=None, sigma: float = 0.0):
    """``y = x * f_row`` (``+ sigma * z``) over a ``(rows * tiles, TILE)``
    plane with one f32 factor per logical row (``factor``: ``(rows,)``),
    in f32 and written in ``planes``' dtype.  The product and the noise
    term ``sigma * z`` are rounded apart, then added."""
    tiles = planes.shape[0] // factor.shape[0]
    f = factor.to(_F32).repeat_interleave(tiles).unsqueeze(1)
    y = planes.to(_F32) * f
    if noise is not None:
        y = y + sigma * noise.to(_F32)
    return y.to(planes.dtype)


def smooth_factors(partials, rows: int, tau: float):
    """Each row's Definition-2 factor ``tau / (tau + ||row||)`` from its
    tiles' partial sums of squares (``partials``: ``(rows * T,)`` f32),
    in the fused kernel's fixed order: the row's T partials padded with
    +0.0 to a multiple of 32, lane l of 32 adding partials l, l + 32,
    l + 64, ... in sequence, then a halving tree over the lanes (lane
    i + off onto lane i, off = 16 ... 1).  Sums of squares are >= +0, so
    the pads are exact.  Then the correctly rounded square root,
    ``RN(f32(tau) + norm)`` and the correctly rounded quotient (a tensor
    dividend: PyTorch computes ``float / tensor`` as
    ``tensor.reciprocal() * float``)."""
    return sumsq_factors(row_sumsq(partials, rows), tau)


def row_sumsq(partials, rows: int):
    """Each row's sum of squares from its tiles' partials, in
    :func:`smooth_factors`' fixed order -> ``(rows,)`` f32."""
    lanes = partials.view(rows, -1).to(_F32)
    lanes = torch.nn.functional.pad(lanes, (0, -lanes.shape[1] % 32))
    lanes = lanes.view(rows, -1, 32)
    s = lanes[:, 0]
    for j in range(1, lanes.shape[1]):
        s = s + lanes[:, j]
    for off in (16, 8, 4, 2, 1):
        s = s[:, :off] + s[:, off:2 * off]
    return s[:, 0]


def sumsq_factors(s, tau: float):
    """Definition 2's factor ``tau / (tau + sqrt(s))`` from a sum of
    squares, as :func:`smooth_factors` finishes it."""
    t = torch.full_like(s, tau)
    return t / (t + sqrt_rn(s))


def clip_planes_ref(planes, rows: int, tau: float, noise=None,
                    sigma: float = 0.0):
    """The fused clip's plain composition over a ``(rows * T, TILE)``
    plane: :func:`clip_sumsq`, :func:`smooth_factors`,
    :func:`clip_scale_ref`.  Returns (the clipped plane in ``planes``'
    dtype, the ``(rows * T,)`` partials, the ``(rows,)`` factors)."""
    partials = clip_sumsq(planes)
    factors = smooth_factors(partials, rows, tau)
    return clip_scale_ref(planes, factors, noise, sigma), partials, factors


def _inv(b: int):
    """``RN(1 / b)`` in f32: the quotient of two CPU tensors, correctly
    rounded."""
    return torch.ones((), dtype=_F32) / torch.tensor(float(b), dtype=_F32)


def _sample_sum(x, dim: int, acc=None):
    """The samples along ``dim`` added in order in f32 onto ``acc`` (a
    running sum of earlier samples), or onto +0.0."""
    if acc is None:
        acc = torch.zeros(x.select(dim, 0).shape, dtype=_F32, device=x.device)
    for s in range(x.shape[dim]):
        acc = acc + x.select(dim, s).to(_F32)
    return acc


def sample_mean(x, dim: int):
    """The mean over axis ``dim`` as the reference's jitted
    ``clipped_grad_accumulate`` takes it: the samples added in order onto
    +0.0 in f32 (a -0.0 sum becomes +0.0), then the product with
    ``RN(1 / b)``, which is what XLA makes of ``acc / b`` (eager JAX and
    PyTorch's CPU divide, correctly rounded; PyTorch's CUDA divides by a
    Python scalar through its reciprocal).  ``RN(1 / b)`` is the f32
    quotient of two CPU tensors, correctly rounded.  Returns f32."""
    return _sample_sum(x, dim) * _inv(x.shape[dim]).to(x.device)


def dp_mean_noise_ref(planes, groups: int, b: int, noise=None,
                      sigma: float = 0.0, acc=None, finish: bool = True,
                      b_total=None):
    """Each group's sample mean over a ``(groups * b * T, TILE)`` plane of
    clipped samples (group g's sample s is logical row ``g * b + s``, each
    of T tiles): :func:`sample_mean` over the b samples, plus ``RN(sigma *
    z)`` with the f32 ``(groups * T, TILE)`` ``noise`` when given, rounded
    apart.  Over chunks of a batch: the sum starts from the f32 running sum
    ``acc`` when given, ``finish=False`` returns the raw sum, and the last
    chunk multiplies by ``RN(1 / b_total)`` (``b_total``: b when None).
    Returns the f32 ``(groups * T, TILE)`` plane."""
    tiles = planes.shape[0] // (groups * b)
    width = planes.shape[1]
    if acc is not None:
        acc = acc.view(groups, tiles, width)
    total = _sample_sum(planes.view(groups, b, tiles, width), 1, acc)
    total = total.view(groups * tiles, width)
    if not finish:
        return total
    mean = total * _inv(b if b_total is None else b_total).to(planes.device)
    return mean if noise is None else mean + sigma * noise.to(_F32)


def smooth_clip_ref(x, tau: float, noise=None, sigma: float = 0.0):
    """Definition 2 over the flattened tensor (``tau / (tau + ||x||) * x``,
    the quotient correctly rounded), plus ``sigma * noise`` when given; f32
    inside, the result in ``x``'s dtype."""
    xf = x.to(_F32)
    norm = torch.linalg.vector_norm(xf.reshape(-1))
    y = xf * (torch.full_like(norm, tau) / (tau + norm))
    if noise is not None:
        y = y + sigma * noise.to(_F32)
    return y.to(x.dtype)


def block_topk_ref(windows, k: int):
    """Keep the k largest magnitudes of each row, zero the rest (+0.0);
    ties at the k-th magnitude go to the lowest index, as
    ``jax.lax.top_k``'s: the stable descending sort of the whole-row
    ``top_k`` compressor (``core.compression._keep_top``; ``torch.topk``
    promises no order among ties)."""
    from ..core.compression import _keep_top
    return _keep_top(windows, k)


def _layout():
    """:mod:`repro_torch.core.wire_formats`, which imports this module, so
    it is looked up at call time."""
    from ..core import wire_formats
    return wire_formats


def topk_pack_ref(rows, k: int):
    """Per-window top-k pack: ``(nb, PACK_BLOCK)`` f32 -> (bf16 values
    ``(nb, k)``, int16 window-local indices ``(nb, k)``).

    The bisection threshold keeps >= k elements; the first k of them in
    index order (``rank = cumsum(keep) - 1``) fill the k slots, so the
    segments are index-ordered.  Values keep their sign, -0 included.
    """
    wf = _layout()
    rows = rows.to(_F32)
    a = rows.abs()
    keep = a >= wf.bisect_threshold(a, k).unsqueeze(-1)
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    col = torch.where(keep & (rank < k), rank, k).long()   # spill -> slot k
    pos = torch.arange(rows.shape[1], device=rows.device).expand_as(col)
    nb = rows.shape[0]
    vals = torch.zeros(nb, k + 1, dtype=_F32, device=rows.device)
    idx = torch.zeros(nb, k + 1, dtype=torch.int64, device=rows.device)
    vals = vals.scatter(1, col, rows)[:, :k]
    idx = idx.scatter(1, col, pos)[:, :k]
    return vals.to(wf.TOPK_VALUE_DTYPE), idx.to(wf.TOPK_INDEX_DTYPE)


def topk_unpack_ref(vals, idx):
    """``(bf16 (nb, k), int16 (nb, k)) -> (nb, PACK_BLOCK)`` f32: each value
    added onto a zero window at its index (so -0 unpacks to +0), as the
    reference's ``.at[].add``: an index is its u16 bit pattern, one at or
    past ``PACK_BLOCK`` is dropped, and duplicates are summed (in slot
    order on the CPU; the card's ``scatter_add`` adds them with atomics).
    Dropped slots land in a spill column past the window."""
    block = _layout().PACK_BLOCK
    col = idx.long() & 0xFFFF
    col = torch.where(col < block, col, block)
    out = torch.zeros(vals.shape[0], block + 1, dtype=_F32,
                      device=vals.device)
    return out.scatter_add(1, col, vals.to(_F32))[:, :block].contiguous()


def qsgd_sumsq(rows):
    """Per-row sum of squares in the kernels' fixed order: each of width / 8
    partials (256 threads of ``qsgd_pack`` over a 2048 window, 1024 of
    ``sumsq`` over an 8192 tile) sums its 8 consecutive squares in
    sequence, then a halving tree adds partial ``i + half`` onto partial
    ``i``."""
    sq = rows * rows
    parts = sq.reshape(rows.shape[0], -1, 8)
    s = parts[..., 0]
    for j in range(1, 8):
        s = s + parts[..., j]
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


def qsgd_pack_ref(rows, noise, levels: int):
    """Per-window QSGD quantize and bit-pack: ``(nb, PACK_BLOCK)`` f32 and
    its U[0, 1) ``noise`` -> (int32 words ``(nb, W)``, f32 scales
    ``(nb, 1)``).

    ``norm = sqrt(sumsq) + 1e-30``, ``y = |x| / norm * levels``,
    ``code = floor(y) + (u < y - floor(y))``; field ``code | sign <<
    (bits - 1)`` goes to bit ``bits * e`` of word ``i // epw``; the scale is
    ``norm / f32(levels * (1 + omega))``.  Words are formed in int64 and
    narrowed to the int32 of the same 32 bits.
    """
    wf = _layout()
    bits = wf.qsgd_bits(levels)
    epw = wf.qsgd_elems_per_word(levels)
    words = wf.qsgd_words_per_window(levels)
    rows = rows.to(_F32)
    norm = sqrt_rn(qsgd_sumsq(rows)) + 1e-30
    y = rows.abs() / norm.unsqueeze(1) * float(levels)
    lo = torch.floor(y)
    code = (lo + (noise < (y - lo)).to(_F32)).to(torch.int64)
    field = code | ((rows < 0).to(torch.int64) << (bits - 1))
    field = torch.nn.functional.pad(field, (0, words * epw - rows.shape[1]))
    field = field.reshape(rows.shape[0], words, epw)
    word = torch.zeros(rows.shape[0], words, dtype=torch.int64,
                       device=rows.device)
    for e in range(epw):
        word = word | (field[:, :, e] << (bits * e))
    word = word & 0xFFFFFFFF              # a 32-bit word keeps 32 bits
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which is not the f32 quotient
    denom = torch.full_like(norm, wf.qsgd_scale_denominator(levels))
    return word.to(torch.int32), (norm / denom).unsqueeze(1)


def qsgd_unpack_ref(word, scale, levels: int):
    """``(int32 (nb, W), f32 (nb, 1)) -> (nb, PACK_BLOCK)`` f32: each field
    ``f`` unpacks to ``(sgn * code) * scale`` with ``sgn = 1 - 2 * (f >>
    (bits - 1))``."""
    wf = _layout()
    bits = wf.qsgd_bits(levels)
    epw = wf.qsgd_elems_per_word(levels)
    mag_mask, field_mask = 2 ** (bits - 1) - 1, 2 ** bits - 1
    cols = []
    for e in range(epw):
        f = (word >> (bits * e)) & field_mask
        code = (f & mag_mask).to(_F32)
        sgn = 1.0 - 2.0 * (f >> (bits - 1)).to(_F32)
        cols.append(sgn * code)
    vals = torch.stack(cols, dim=2).reshape(word.shape[0], -1)
    return vals[:, :wf.PACK_BLOCK] * scale


def _cumsum_f32(x, dim: int):
    """Inclusive cumsum by sequential f32 adds, the order of the reference
    (XLA) and of the kernel; PyTorch's CPU ``cumsum`` accumulates in f64."""
    acc = x.select(dim, 0)
    parts = [acc]
    for t in range(1, x.shape[dim]):
        acc = acc + x.select(dim, t)
        parts.append(acc)
    return torch.stack(parts, dim=dim)


def rwkv6_chunk_ref(r, k, v, logw, u, s0):
    """The chunked RWKV6 scan (``repro.nn.ssm._rwkv_chunk_scan``), in f32 and
    in the reference's order of operations.

    r, k, v, logw: ``(B, S, H, N)`` with ``S % 16 == 0``; u: ``(H, N)``;
    s0: ``(B, H, N, N)``.  Returns o ``(B, S, H, N)`` and the final state
    ``(B, H, N, N)``, both f32.  The intra-chunk product is formed whole
    and then masked (``qk * tri``), as the reference does.
    """
    b, s, h, n = r.shape
    c = RWKV_CHUNK
    nc = s // c
    rs, ks, vs, lw = (x.reshape(b, nc, c, h, n).to(_F32)
                      for x in (r, k, v, logw))
    la = _cumsum_f32(lw, dim=2)                      # inclusive
    la_prev = la - lw                                # exclusive
    la_end = la[:, :, -1:]                           # (B,NC,1,H,N)

    rq = rs * torch.exp(la_prev)
    kk = ks * torch.exp(-la)
    kend = ks * torch.exp(la_end - la)

    qk = torch.einsum("bnthd,bnshd->bnhts", rq, kk)  # (B,NC,H,C,C)
    tri = torch.tril(torch.ones(c, c, dtype=_F32, device=r.device),
                     diagonal=-1)
    qk = qk * tri
    bonus = torch.einsum("bnthd,hd,bnthd->bnth", rs, u.to(_F32), ks)
    o_intra = torch.einsum("bnhts,bnshd->bnthd", qk, vs)
    o_intra = o_intra + bonus[..., None] * vs

    state = s0.to(_F32)
    o_inter = []
    for i in range(nc):
        o_inter.append(torch.einsum("bthk,bhkv->bthv", rq[:, i], state))
        outer = torch.einsum("bthk,bthv->bhkv", kend[:, i], vs[:, i])
        decay = torch.exp(la_end[:, i, 0])           # (B,H,N) on the k-dim
        state = state * decay[..., None] + outer
    o = o_intra + torch.stack(o_inter, dim=1)
    return o.reshape(b, s, h, n), state


def rwkv6_scan_ref(r, k, v, logw, u, s0):
    """The exact per-token RWKV6 recurrence (``repro.nn.ssm.rwkv_scan_ref``,
    ``repro.kernels.ref.rwkv6_scan_ref``), any S, in f32::

        o_t = r_t S + (r_t . (u * k_t)) v_t;   S = diag(w_t) S + k_t v_t^T
    """
    state = s0.to(_F32)
    uf = u.to(_F32)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = (x[:, t].to(_F32) for x in (r, k, v))
        wt = torch.exp(logw[:, t].to(_F32))
        ot = torch.einsum("bhk,bhkv->bhv", rt, state)
        bonus = torch.einsum("bhk,hk,bhk->bh", rt, uf, kt)
        outs.append(ot + bonus[..., None] * vt)
        state = state * wt[..., None] + kt[..., None] * vt[:, :, None, :]
    return torch.stack(outs, dim=1), state


def ssd_chunk_ref(xh, bmat, cmat, dla, h0):
    """The chunked Mamba2 SSD scan (``repro.nn.ssm._ssd_chunk_scan``), in f32
    and in the reference's order of operations.

    xh: ``(B, S, H, P)`` dt-scaled inputs with ``S % 64 == 0``; bmat, cmat:
    ``(B, S, N)``; dla: ``(B, S, H)`` per-step log-decay; h0: ``(B, H, P,
    N)``.  Returns y ``(B, S, H, P)`` and the final state ``(B, H, P, N)``,
    both f32.  The decay matrix exp(la_t - la_s) is masked to -inf above
    the diagonal before ``exp``, as the reference does.
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    c = SSD_CHUNK
    nc = s // c
    xs = xh.reshape(b, nc, c, h, p).to(_F32)
    bs = bmat.reshape(b, nc, c, n).to(_F32)
    cs = cmat.reshape(b, nc, c, n).to(_F32)
    lrel = _cumsum_f32(dla.reshape(b, nc, c, h).to(_F32), dim=2)
    lend = lrel[:, :, -1:, :]                         # (B,NC,1,H)

    dmat = lrel[:, :, :, None, :] - lrel[:, :, None, :, :]   # (B,NC,C,C,H)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=xh.device))
    dmat = torch.where(tri[None, None, :, :, None], dmat,
                       torch.full((), -torch.inf, device=xh.device))
    dec = torch.exp(dmat)
    cb = torch.einsum("bntk,bnsk->bnts", cs, bs)      # (B,NC,C,C)
    m = cb[..., None] * dec
    y_intra = torch.einsum("bntsh,bnshp->bnthp", m, xs)

    kend = torch.exp(lend - lrel)                     # (B,NC,C,H)
    xdec = xs * kend[..., None]
    outer = torch.einsum("bnchp,bnck->bnhpk", xdec, bs)      # (B,NC,H,P,N)
    cin = torch.exp(lrel)

    state = h0.to(_F32)
    y_inter = []
    for i in range(nc):
        y_inter.append(torch.einsum("bck,bhpk,bch->bchp", cs[:, i], state,
                                    cin[:, i]))
        state = state * torch.exp(lend[:, i, 0])[:, :, None, None] + outer[:, i]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, h, p), state


def ssd_scan_ref(xh, bmat, cmat, dla, h0):
    """The exact per-token SSD recurrence (``repro.nn.ssm.ssd_scan_ref``),
    any S, in f32::

        h_t = exp(dla_t) h_{t-1} + xh_t B_t^T;   y_t = h_t C_t
    """
    state = h0.to(_F32)
    ys = []
    for t in range(xh.shape[1]):
        a_t = torch.exp(dla[:, t].to(_F32))           # (B,H)
        outer = torch.einsum("bhp,bk->bhpk", xh[:, t].to(_F32),
                             bmat[:, t].to(_F32))
        state = state * a_t[..., None, None] + outer
        ys.append(torch.einsum("bk,bhpk->bhp", cmat[:, t].to(_F32), state))
    return torch.stack(ys, dim=1), state
