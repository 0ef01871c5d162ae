"""Public wrappers of the port's kernels: checks, dispatch, launch counts.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only because its tensors lie on the CPU.  For CUDA tensors it launches the
hand-written kernel or raises: there is no fallback.  Each launch adds one
to its kernel's entry in :data:`LAUNCHES` (``sr_cast`` and ``sr_cast_leaf``
both launch the ``sr_cast`` kernel), so a run can show that its main path
went through the kernels (``chip_smoke.py`` zeroes the counts before the
path and reads them after).  ``LAUNCHES["sr_epilogue"]`` counts no launch:
it counts the outputs an ef kernel rounded stochastically in its epilogue
on the card (one per output given words).

The wire codecs (``wire_topk_pack`` / ``wire_topk_unpack`` /
``wire_qsgd_pack`` / ``wire_qsgd_unpack``) take ``(R, PACK_BLOCK)`` windows
and the wire dtypes of :mod:`repro_torch.core.wire_formats`: bf16 values
with int16 indices (top-k), int32 words with f32 scales (qsgd).  qsgd's
U[0, 1) noise is an operand, drawn by the caller.

The smooth clip runs Definition 2 over a flat ``(rows * tiles, TILE)``
plane of f32 or bf16 that stacks rows (agents, or samples).
:func:`clip_planes` is one launch of the fused ``clip`` kernel: one
partial sum of squares a tile, each row's factor ``tau / (tau + ||row||)``
from its partials in :func:`smooth_factors`' fixed order, then the scale
(``+ sigma * z`` with a noise plane); a thread block cluster a row of at
most 8 tiles, else one cooperative launch with a grid-wide barrier.  The
reference's wrapper runs ``sumsq``, ``jnp.sum`` and ``scale``
(``src/repro/kernels/ops.py:59-61``).  The two passes also stand alone:
``clip_sumsq`` (the ``sumsq`` kernel) and ``clip_scale`` (``scale``, or
``scale_noise`` with a noise plane: the DP perturbation at factor 1).
``dp_mean_noise`` is the clipped samples' mean, and its DP perturbation,
in one launch (``mean_noise``, a kernel of the port alone): each group's b
samples added in order onto +0.0, times ``RN(1 / b)`` (the reference's
jitted mean), plus ``sigma * z`` when a noise plane is given; every
per-sample clipped mean runs it.
``smooth_clip`` keeps the reference's contract: one norm over the whole
array.  ``block_topk`` keeps exactly k per ``(R, 2048)`` window, ties to
the lower index.

``rwkv6_scan`` is the RWKV6 chunked scan of the rwkv6 serving path, with
the reference's contract (``src/repro/kernels/ops.py:230``); ``ssd_scan``
the Mamba2 SSD chunked scan of the zamba2 serving path
(``src/repro/kernels/ops.py:256``).  Neither has a backward yet, so a CUDA
operand that requires grad raises.

Operand types of the ef updates, as the comm-round engine issues them: all
f32; ``ef_track`` with every operand bf16; ``ef_step`` / ``ef_gossip`` with
bf16 EF operands beside an f32 ``x`` / ``y``.  ``out_dtype`` is None (each
output in its state operand's dtype) or f32 (all three).  ``sr_bits``
(exclusive with ``out_dtype``) rounds the bf16 outputs stochastically: one
contiguous int32 plane of the operands' shape for each bf16 state slot,
None for the f32 one (the engine's two modes: words on all three outputs
of an all-bf16 ``ef_track``, on q and m beside an f32 ``x`` / ``y``).  The
result is bitwise the f32 outputs followed by ``sr_cast`` on each output
given words; on the card that rounding is the ef kernel's epilogue, on the
CPU it is that composite of the plain versions.
"""

from __future__ import annotations

import torch

from ..core import wire_formats as WF
from . import block_topk as _bt
from . import ef_update as _ef
from . import ref
from . import rwkv6_chunk as _rw
from . import smooth_clip as _sc
from . import sr_cast as _srk
from . import ssd_chunk as _ssd
from . import wire_pack as _wp
from . import flatten as FL
from .flatten import TILE

__all__ = ["LAUNCHES", "reset_launches", "ef_track", "ef_step", "ef_gossip",
           "sr_cast", "sr_cast_leaf", "clip_sumsq", "clip_scale",
           "smooth_factors", "clip_planes", "dp_mean_noise", "smooth_clip",
           "block_topk",
           "wire_topk_pack", "wire_topk_unpack", "wire_qsgd_pack", "wire_qsgd_unpack",
           "rwkv6_scan", "ssd_scan"]

LAUNCHES = {"ef_track": 0, "ef_step": 0, "ef_gossip": 0, "sr_cast": 0,
            "sumsq": 0, "scale": 0, "scale_noise": 0, "clip": 0,
            "mean_noise": 0,
            "block_topk": 0,
            "topk_pack": 0, "topk_unpack": 0, "qsgd_pack": 0,
            "qsgd_unpack": 0, "rwkv6_chunk": 0, "ssd_chunk": 0,
            "sr_epilogue": 0}

_F32, _BF16 = torch.float32, torch.bfloat16
# (EF operands' dtype, slot-2 operand's dtype) each kernel takes
_MIXES = {"ef_track": ((_F32, _F32), (_BF16, _BF16)),
          "ef_step": ((_F32, _F32), (_BF16, _F32)),
          "ef_gossip": ((_F32, _F32), (_BF16, _F32))}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_layout(name: str, tensors) -> str:
    """Same-shape contiguous operands on one device; returns the device
    type."""
    lead = tensors[0]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
        if t.shape != lead.shape or t.device != lead.device:
            raise ValueError(
                f"{name} operands must share shape and device; got "
                f"{tuple(t.shape)} on {t.device} next to "
                f"{tuple(lead.shape)} on {lead.device}")
    kind = lead.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {kind}")
    return kind


def _check_ef(name: str, tensors, out_dtype) -> str:
    """The operand mix and output mode of an ef kernel, then the layout."""
    ef = {t.dtype for i, t in enumerate(tensors) if i != 2}
    mix = (ef.pop() if len(ef) == 1 else None, tensors[2].dtype)
    if mix not in _MIXES[name]:
        raise TypeError(
            f"{name} takes the operand mixes (EF operands, slot 2) "
            f"{_MIXES[name]}; got {[t.dtype for t in tensors]}")
    if out_dtype not in (None, _F32):
        raise TypeError(f"{name}: out_dtype must be None or float32, got "
                        f"{out_dtype}")
    return _check_layout(name, tensors)


def _check_words(name: str, tensors, out_dtype, sr_bits):
    """The words of the stochastic-rounding epilogue, checked: a 3-tuple
    with an int32 plane like the operands exactly where the state slot
    (0-2) is bf16, or None when ``sr_bits`` is None."""
    if sr_bits is None:
        return None
    if out_dtype is not None:
        raise TypeError(f"{name}: sr_bits and out_dtype are exclusive (the "
                        f"words round the bf16 outputs)")
    words = tuple(sr_bits)
    if len(words) != 3:
        raise ValueError(f"{name}: sr_bits takes one entry per output "
                         f"(q, m, y), got {len(words)}")
    if all(w is None for w in words):
        raise ValueError(f"{name}: sr_bits gives no words")
    for slot, (state, w) in enumerate(zip(tensors, words)):
        if (w is not None) != (state.dtype == _BF16):
            raise TypeError(
                f"{name}: sr_bits takes words exactly for the bf16 state "
                f"slots; slot {slot} is {state.dtype} and was given "
                f"{'words' if w is not None else 'None'}")
        if w is None:
            continue
        if w.dtype != torch.int32:
            raise TypeError(f"{name}: sr_bits words must be int32, got "
                            f"{w.dtype}")
        if (w.shape != state.shape or w.device != state.device
                or not w.is_contiguous()):
            raise ValueError(
                f"{name}: sr_bits words must be contiguous, of the "
                f"operands' shape {tuple(state.shape)} on {state.device}; "
                f"got {tuple(w.shape)} on {w.device}")
    return words


def _ef_update(name: str, operands, scalars, out_dtype, sr_bits):
    kind = _check_ef(name, operands, out_dtype)
    words = _check_words(name, operands, out_dtype, sr_bits)
    if kind == "cpu":
        outs = getattr(ref, f"{name}_ref")(
            *operands, *scalars, out_dtype=out_dtype if words is None
            else _F32)
        if words is None:
            return outs
        return tuple(o if w is None else ref.sr_cast_ref(o, w)
                     for o, w in zip(outs, words))
    out = getattr(_ef, name)(*operands, *scalars, out_dtype is not None,
                             words)
    LAUNCHES[name] += 1
    if words is not None:
        LAUNCHES["sr_epilogue"] += sum(w is not None for w in words)
    return out


def ef_track(q, m, v, c, wc, g, gp, gamma: float, out_dtype=None,
             sr_bits=None):
    """Fused Algorithm-1 lines 11-12: returns (q + c, m + wc, v')."""
    return _ef_update("ef_track", (q, m, v, c, wc, g, gp), (gamma,),
                      out_dtype, sr_bits)


def ef_step(q, m, x, c, wc, v, gamma: float, eta: float, out_dtype=None,
            sr_bits=None):
    """Fused Algorithm-1 lines 13-14: returns (q + c, m + wc, x')."""
    return _ef_update("ef_step", (q, m, x, c, wc, v), (gamma, eta),
                      out_dtype, sr_bits)


def ef_gossip(q, m, y, c, wc, gamma: float, scale: float = 1.0,
              out_dtype=None, sr_bits=None):
    """Fused CHOCO / SoteriaFL round: returns (q + s*c, m + s*wc, y')."""
    return _ef_update("ef_gossip", (q, m, y, c, wc), (gamma, scale),
                      out_dtype, sr_bits)


def _sr_cast(name: str, x, bits):
    if x.dtype != _F32 or bits.dtype != torch.int32:
        raise TypeError(f"{name} takes f32 values and int32 bits, got "
                        f"{x.dtype} and {bits.dtype}")
    if _check_layout(name, (x, bits)) == "cpu":
        return ref.sr_cast_ref(x, bits)
    out = _srk.sr_cast(x, bits)
    LAUNCHES["sr_cast"] += 1
    return out


def sr_cast(x, bits):
    """Stochastically round an f32 ``(tiles, TILE)`` plane to bf16 with the
    int32 random words ``bits`` (same shape; low 16 bits used)."""
    if x.dim() != 2 or x.shape[-1] != TILE:
        raise ValueError(f"sr_cast takes a (tiles, {TILE}) plane, got "
                         f"{tuple(x.shape)}; use sr_cast_leaf for a leaf")
    return _sr_cast("sr_cast", x, bits)


def sr_cast_leaf(x, bits):
    """The same cast over one leaf of any shape, without plane padding
    (``bits`` in ``x``'s shape); ``x`` is taken to f32 first."""
    return _sr_cast("sr_cast_leaf", x.to(_F32).contiguous(), bits)


def _check_plane(name: str, tensors, width: int) -> str:
    """Contiguous ``(rows, width)`` operands of one dtype, f32 or bf16, on
    one device (see :func:`_check_wire`).  Returns the device type."""
    dt = tensors[0].dtype
    if dt not in (_F32, _BF16):
        raise TypeError(f"{name} takes f32 or bf16 operands, got {dt}")
    return _check_wire(name, tensors, (dt,) * len(tensors),
                       (width,) * len(tensors))


def clip_sumsq(planes):
    """Per-tile sum of squares of a ``(tiles, TILE)`` f32 or bf16 plane, in
    f32 and in a fixed order -> ``(tiles,)`` f32."""
    if _check_plane("clip_sumsq", (planes,), TILE) == "cpu":
        return ref.clip_sumsq(planes)
    out = _sc.sumsq(planes)
    LAUNCHES["sumsq"] += 1
    return out


def clip_scale(planes, factor, noise=None, sigma: float = 0.0):
    """``planes * factor[row]`` (``+ sigma * noise``) over a ``(rows *
    tiles, TILE)`` plane, f32 inside, in ``planes``' dtype.  ``factor``:
    ``(rows,)`` f32, one per logical row of ``tiles`` consecutive plane
    rows; ``noise``: a plane like ``planes``.  The noise form launches the
    ``scale_noise`` kernel."""
    operands = (planes,) if noise is None else (planes, noise)
    kind = _check_plane("clip_scale", operands, TILE)
    if (factor.dim() != 1 or factor.dtype != _F32
            or not factor.is_contiguous() or factor.device != planes.device
            or factor.shape[0] < 1 or planes.shape[0] % factor.shape[0]):
        raise ValueError(
            f"clip_scale takes a contiguous f32 (rows,) factor on the "
            f"plane's device whose length divides the plane's "
            f"{planes.shape[0]} tiles, got {factor.dtype} "
            f"{tuple(factor.shape)} on {factor.device}")
    if kind == "cpu":
        return ref.clip_scale_ref(planes, factor, noise, sigma)
    out = _sc.scale(planes, factor, noise, sigma)
    LAUNCHES["scale" if noise is None else "scale_noise"] += 1
    return out


smooth_factors = ref.smooth_factors


def clip_planes(planes, rows: int, tau: float, noise=None,
                sigma: float = 0.0):
    """Definition 2 over a ``(rows * T, TILE)`` f32 or bf16 plane, each
    logical row of T tiles by its own norm (plus ``sigma * noise``, a plane
    like ``planes``): on the card one launch of the fused ``clip`` kernel
    (per-tile sums, each row's factor, the scale), on the CPU its plain
    composition ``ref.clip_planes_ref`` (:func:`clip_sumsq`'s order, then
    :func:`smooth_factors`, then :func:`clip_scale`'s arithmetic), bit for
    bit.  Returns (the clipped plane, the ``(rows * T,)`` partials, the
    ``(rows,)`` factors)."""
    operands = (planes,) if noise is None else (planes, noise)
    kind = _check_plane("clip_planes", operands, TILE)
    if rows < 1 or planes.shape[0] % rows:
        raise ValueError(f"clip_planes takes a row count that divides the "
                         f"plane's {planes.shape[0]} tiles, got {rows}")
    if kind == "cpu":
        return ref.clip_planes_ref(planes, rows, tau, noise, sigma)
    out = _sc.clip(planes, rows, tau, noise, sigma)
    LAUNCHES["clip"] += 1
    return out


def dp_mean_noise(planes, groups: int, b: int, noise=None,
                  sigma: float = 0.0, acc=None, finish: bool = True,
                  b_total=None):
    """Each group's sample mean, and its DP perturbation when ``noise`` is
    given: ``planes`` is a ``(groups * b * T, TILE)`` f32 or bf16 plane of
    clipped samples (group g's sample s is logical row ``g * b + s``, as
    ``clip_planes`` leaves them), ``noise`` None or the f32 ``(groups * T,
    TILE)`` plane of N(0, 1) draws.  Returns the f32 ``(groups * T, TILE)``
    plane ``mean_s x[g, s] (+ sigma * z[g])``: on the card one launch of
    the ``mean_noise`` kernel, on the CPU ``ref.dp_mean_noise_ref``, bit
    for bit (the samples added in order onto +0.0, the product with ``RN(1
    / b)``, then ``RN(sigma * z)`` added).

    A batch taken in chunks of samples calls it once a chunk: ``acc`` is
    the f32 running sum of the earlier chunks (a plane of the output's
    shape; the sum starts there, not at +0.0), ``finish=False`` returns
    the raw running sum (no product, no noise), and the last chunk's call
    (``finish=True``) multiplies by ``RN(1 / b_total)``, ``b_total`` the
    whole batch (b when None), and adds the noise: bitwise the one-shot
    call over the whole batch."""
    kind = _check_plane("dp_mean_noise", (planes,), TILE)
    b_total = b if b_total is None else b_total
    if (groups < 1 or b < 1 or b_total < b
            or planes.shape[0] % (groups * b)):
        raise ValueError(f"dp_mean_noise takes {groups} groups of b = {b} "
                         f"samples (of b_total = {b_total} >= b) whose count "
                         f"divides the plane's {planes.shape[0]} tiles")
    want = (planes.shape[0] // b, TILE)
    for what, plane in (("noise", noise), ("acc", acc)):
        if plane is None:
            continue
        _check_wire("dp_mean_noise", (plane,), (_F32,), (TILE,))
        if tuple(plane.shape) != want or plane.device != planes.device:
            raise ValueError(f"dp_mean_noise takes a{'n' * (what == 'acc')} "
                             f"{what} plane of shape {want} on "
                             f"{planes.device}, got {tuple(plane.shape)} on "
                             f"{plane.device}")
    if noise is not None and not finish:
        raise ValueError("dp_mean_noise adds the noise on the last chunk "
                         "only (finish=True)")
    if kind == "cpu":
        return ref.dp_mean_noise_ref(planes, groups, b, noise, sigma, acc,
                                     finish, b_total)
    out = _sc.mean_noise(planes, groups, b, noise, sigma, acc, finish,
                         b_total)
    LAUNCHES["mean_noise"] += 1
    return out


def smooth_clip(x, tau: float, noise=None, sigma: float = 0.0):
    """Definition 2 over a whole f32 or bf16 array of any shape (one norm),
    plus ``sigma * noise`` (an array like ``x``) when given: the
    reference's ``repro.kernels.ops.smooth_clip``."""
    if noise is not None and (noise.shape != x.shape
                              or noise.dtype != x.dtype):
        raise ValueError(f"smooth_clip takes noise of x's shape and dtype, "
                         f"got {noise.dtype} {tuple(noise.shape)} beside "
                         f"{x.dtype} {tuple(x.shape)}")
    spec = FL.flat_spec(x, stacked=False)
    z = None if noise is None else FL.to_planes(noise, spec)
    return FL.from_planes(clip_planes(FL.to_planes(x, spec), 1, tau, z,
                                      sigma)[0], spec)


def block_topk(windows, k: int):
    """Keep the k largest magnitudes of each ``(R, 2048)`` f32 or bf16
    window, +0.0 elsewhere; ties to the lower index (exactly k kept)."""
    if not 1 <= k <= WF.PACK_BLOCK:
        raise ValueError(f"k must be in [1, {WF.PACK_BLOCK}], got {k}")
    if _check_plane("block_topk", (windows,), WF.PACK_BLOCK) == "cpu":
        return ref.block_topk_ref(windows, k)
    out = _bt.block_topk(windows, k)
    LAUNCHES["block_topk"] += 1
    return out


def _check_wire(name: str, tensors, dtypes, widths) -> str:
    """2-D contiguous operands on one device with the given dtypes, last
    dims ``widths`` (None: any) and a common first dim; 16-byte aligned on
    the card (the kernels read and write whole vectors).  Returns the
    device type."""
    lead = tensors[0]
    for t, dt, width in zip(tensors, dtypes, widths):
        if t.dtype != dt:
            raise TypeError(f"{name} takes {list(dtypes)}, got "
                            f"{[x.dtype for x in tensors]}")
        if (t.dim() != 2 or t.shape[0] != lead.shape[0] or t.shape[0] < 1
                or (width is not None and t.shape[1] != width)):
            raise ValueError(
                f"{name} takes 2-D operands of widths {list(widths)} over "
                f"the same rows, got {[tuple(x.shape) for x in tensors]}")
        if not t.is_contiguous() or t.device != lead.device:
            raise ValueError(f"{name} needs contiguous operands on one device")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned operands")
    kind = lead.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {kind}")
    return kind


def _check_levels(levels: int) -> None:
    if not 1 <= levels <= 2 ** 15 - 1:
        raise ValueError(f"qsgd levels must be in [1, 32767], got {levels}")


def wire_topk_pack(rows, k: int):
    """Per-window top-k select and pack: ``(R, PACK_BLOCK)`` f32 -> (bf16
    values, int16 indices), each ``(R, k)``."""
    if not 1 <= k <= WF.PACK_BLOCK:
        raise ValueError(f"k must be in [1, {WF.PACK_BLOCK}], got {k}")
    if _check_wire("wire_topk_pack", (rows,), (torch.float32,),
                   (WF.PACK_BLOCK,)) == "cpu":
        return ref.topk_pack_ref(rows, k)
    out = _wp.topk_pack(rows, k)
    LAUNCHES["topk_pack"] += 1
    return out


def wire_topk_unpack(vals, idx):
    """Packed ``(R, k)`` values and indices -> dense f32 ``(R,
    PACK_BLOCK)``, as the reference's scatter-add: an index is its u16 bit
    pattern, one at or past ``PACK_BLOCK`` is dropped, and duplicates are
    summed in slot order."""
    if vals.dim() != 2 or idx.shape != vals.shape:
        raise ValueError(f"wire_topk_unpack takes (R, k) values and indices, "
                         f"got {tuple(vals.shape)} and {tuple(idx.shape)}")
    if _check_wire("wire_topk_unpack", (vals, idx),
                   (WF.TOPK_VALUE_DTYPE, WF.TOPK_INDEX_DTYPE),
                   (None, None)) == "cpu":
        return ref.topk_unpack_ref(vals, idx)
    out = _wp.topk_unpack(vals, idx)
    LAUNCHES["topk_unpack"] += 1
    return out


def wire_qsgd_pack(rows, noise, levels: int):
    """Per-window QSGD quantize and bit-pack: ``(R, PACK_BLOCK)`` f32 and
    its U[0, 1) noise -> (int32 words ``(R, W)``, f32 scales ``(R, 1)``)."""
    _check_levels(levels)
    if _check_wire("wire_qsgd_pack", (rows, noise),
                   (torch.float32, torch.float32),
                   (WF.PACK_BLOCK, WF.PACK_BLOCK)) == "cpu":
        return ref.qsgd_pack_ref(rows, noise, levels)
    out = _wp.qsgd_pack(rows, noise, levels)
    LAUNCHES["qsgd_pack"] += 1
    return out


def wire_qsgd_unpack(words, scale, levels: int):
    """Bit-packed words and scales -> dense f32 ``(R, PACK_BLOCK)``."""
    _check_levels(levels)
    if _check_wire("wire_qsgd_unpack", (words, scale),
                   (WF.QSGD_WORD_DTYPE, torch.float32),
                   (WF.qsgd_words_per_window(levels), 1)) == "cpu":
        return ref.qsgd_unpack_ref(words, scale, levels)
    out = _wp.qsgd_unpack(words, scale, levels)
    LAUNCHES["qsgd_unpack"] += 1
    return out


def _needs_grad(operands) -> bool:
    """True when an operand needs grad or is wrapped by a ``torch.func``
    transform (under ``grad`` or ``vmap`` a tensor's ``requires_grad`` may
    be False, and its ``data_ptr`` is not the batched data's)."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(t.requires_grad or wrapped(t) for t in operands)


def rwkv6_scan(r, k, v, logw, u, s0):
    """RWKV6 chunked linear-attention scan.

    r, k, v, logw: ``(B, S, H, N)`` with ``S % 16 == 0``; u: ``(H, N)``;
    s0: ``(B, H, N, N)``.  Returns (o ``(B, S, H, N)`` f32, s_final
    ``(B, H, N, N)`` f32).  On the card: r, k, v contiguous and all bf16 or
    all f32, logw and s0 contiguous f32, 1 <= N <= 64 (padded on chip to a
    width of :data:`repro_torch.kernels.rwkv6_chunk.WIDTHS`); u is taken to
    f32.
    """
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan takes (B, S, H, N) operands, got "
                         f"{tuple(r.shape)}")
    b, s, h, n = r.shape
    c = ref.RWKV_CHUNK
    if s < c or s % c:
        raise ValueError(f"rwkv6_scan needs S a positive multiple of {c} "
                         f"(pad the sequence), got S = {s}")
    shapes = ((k, r.shape), (v, r.shape), (logw, r.shape), (u, (h, n)),
              (s0, (b, h, n, n)))
    for t, want in shapes:
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"rwkv6_scan operand of shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
    operands = (r, k, v, logw, u, s0)
    if any(t.device != r.device for t in operands):
        raise ValueError("rwkv6_scan operands must share one device")
    kind = r.device.type
    if kind == "cpu":
        return ref.rwkv6_chunk_ref(r, k, v, logw, u, s0)
    if kind != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda tensors, got {kind}")
    if _needs_grad(operands):
        raise RuntimeError("rwkv6_scan's kernel has no backward: train "
                           "through the plain chunked form "
                           "(ref.rwkv6_chunk_ref, plain_scan=True in the "
                           "model), as the reference trains through its jnp "
                           "chunked form")
    if (len({r.dtype, k.dtype, v.dtype}) != 1
            or r.dtype not in (_F32, _BF16) or logw.dtype != _F32
            or s0.dtype != _F32):
        raise TypeError(f"rwkv6_scan takes r, k, v all bf16 or all f32 and "
                        f"f32 logw and s0, got "
                        f"{[t.dtype for t in operands]}")
    if not 1 <= n <= max(_rw.WIDTHS):
        raise ValueError(f"the rwkv6_chunk kernel takes N in [1, "
                         f"{max(_rw.WIDTHS)}], got N = {n} (wider heads: "
                         f"ROADMAP queue 2 item 11)")
    if not all(t.is_contiguous() for t in (r, k, v, logw, s0)):
        raise ValueError("rwkv6_scan needs contiguous operands on the card")
    out = _rw.rwkv6_chunk(r, k, v, logw, u.to(_F32).contiguous(), s0)
    LAUNCHES["rwkv6_chunk"] += 1
    return out


def ssd_scan(xh, bmat, cmat, dla, h0):
    """Mamba2 SSD chunked scan.

    xh: ``(B, S, H, P)`` dt-scaled inputs with ``S % 64 == 0``; bmat, cmat:
    ``(B, S, N)``; dla: ``(B, S, H)`` per-step log-decay; h0: ``(B, H, P,
    N)``.  Returns (y ``(B, S, H, P)`` f32, h_final ``(B, H, P, N)`` f32).
    On the card: xh, dla and h0 contiguous f32 (xh 16-byte aligned); bmat
    and cmat both bf16 or both f32, with the same strides and unit stride
    on N (column slices of one activation are read in place); 1 <= P, N <=
    64 (each padded on chip to a width of
    :data:`repro_torch.kernels.ssd_chunk.WIDTHS`).
    """
    if xh.dim() != 4 or bmat.dim() != 3:
        raise ValueError(f"ssd_scan takes xh (B, S, H, P) and bmat (B, S, N), "
                         f"got {tuple(xh.shape)} and {tuple(bmat.shape)}")
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    c = ref.SSD_CHUNK
    if s < c or s % c:
        raise ValueError(f"ssd_scan needs S a positive multiple of {c} "
                         f"(pad the sequence), got S = {s}")
    shapes = ((bmat, (b, s, n)), (cmat, (b, s, n)), (dla, (b, s, h)),
              (h0, (b, h, p, n)))
    for t, want in shapes:
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"ssd_scan operand of shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
    operands = (xh, bmat, cmat, dla, h0)
    if any(t.device != xh.device for t in operands):
        raise ValueError("ssd_scan operands must share one device")
    kind = xh.device.type
    if kind == "cpu":
        return ref.ssd_chunk_ref(xh, bmat, cmat, dla, h0)
    if kind != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, got {kind}")
    if _needs_grad(operands):
        raise RuntimeError("ssd_scan's kernel has no backward: train through "
                           "the plain chunked form (ref.ssd_chunk_ref, "
                           "plain_scan=True in the model), as the reference "
                           "trains through its jnp chunked form")
    if (bmat.dtype != cmat.dtype or bmat.dtype not in (_F32, _BF16)
            or any(t.dtype != _F32 for t in (xh, dla, h0))):
        raise TypeError(f"ssd_scan takes f32 xh, dla and h0 and bmat, cmat "
                        f"both bf16 or both f32, got "
                        f"{[t.dtype for t in operands]}")
    if not (1 <= p <= max(_ssd.WIDTHS) and 1 <= n <= max(_ssd.WIDTHS)):
        raise ValueError(f"the ssd_chunk kernel takes P and N in [1, "
                         f"{max(_ssd.WIDTHS)}], got P = {p}, N = {n} (wider "
                         f"heads or states: ROADMAP queue 2 item 12)")
    if not all(t.is_contiguous() for t in (xh, dla, h0)) or xh.data_ptr() % 16:
        raise ValueError("ssd_scan needs xh, dla and h0 contiguous (xh "
                         "16-byte aligned) on the card")
    if (bmat.stride() != cmat.stride() or bmat.stride(2) != 1):
        raise ValueError(f"ssd_scan needs bmat and cmat with the same strides "
                         f"and unit stride on N, got {bmat.stride()} and "
                         f"{cmat.stride()}")
    out = _ssd.ssd_chunk(xh, bmat, cmat, dla, h0)
    LAUNCHES["ssd_chunk"] += 1
    return out
