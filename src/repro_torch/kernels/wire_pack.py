"""Launchers for the bit-packed wire codec kernels (``csrc/wire_pack.cu``).

Hand-written Hopper replacements of the Pallas kernels in
``src/repro/kernels/wire_pack.py``:

    topk_pack:    (nb, 2048) f32 -> bf16 values, int16 indices (nb, k)
    topk_unpack:  bf16 values, int16 indices (nb, k) -> (nb, 2048) f32
    qsgd_pack:    (nb, 2048) f32 + U[0,1) noise -> int32 words (nb, W),
                  f32 scales (nb, 1)
    qsgd_unpack:  int32 words, f32 scales -> (nb, 2048) f32

The layout (window, field widths, the scale's denominator) comes from
:mod:`repro_torch.core.wire_formats`.  These functions only allocate and
launch: operand checks, the CPU dispatch and the launch counters live in
:mod:`repro_torch.kernels.ops`.  The library is built and loaded on the
first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import wire_formats as WF
from . import build

__all__ = ["topk_pack", "topk_unpack", "qsgd_pack", "qsgd_unpack"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "topk_pack": [_P, _P, _P, _I64, _I, _P],
    "topk_unpack": [_P, _P, _P, _I64, _I, _P],
    "qsgd_pack": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, ctypes.c_float, _P],
    "qsgd_unpack": [_P, _P, _P, _I64, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("wire_pack")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, lead: torch.Tensor, *args) -> None:
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream(lead.device).cuda_stream
        err = getattr(_lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _qsgd_layout(levels: int):
    return (WF.qsgd_bits(levels), WF.qsgd_elems_per_word(levels),
            WF.qsgd_words_per_window(levels))


def topk_pack(rows, k: int):
    """Launch the top-k pack of contiguous f32 windows ``rows``."""
    nb = rows.shape[0]
    vals = torch.empty(nb, k, dtype=WF.TOPK_VALUE_DTYPE, device=rows.device)
    idx = torch.empty(nb, k, dtype=WF.TOPK_INDEX_DTYPE, device=rows.device)
    _launch("topk_pack", rows, rows.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), nb, k)
    return vals, idx


def topk_unpack(vals, idx):
    """Launch the top-k unpack of ``(nb, k)`` values and indices."""
    nb, k = vals.shape
    out = torch.empty(nb, WF.PACK_BLOCK, dtype=torch.float32,
                      device=vals.device)
    _launch("topk_unpack", vals, vals.data_ptr(), idx.data_ptr(),
            out.data_ptr(), nb, k)
    return out


def qsgd_pack(rows, noise, levels: int):
    """Launch the QSGD pack of f32 windows ``rows`` with U[0,1) ``noise``."""
    nb = rows.shape[0]
    bits, epw, nwords = _qsgd_layout(levels)
    words = torch.empty(nb, nwords, dtype=WF.QSGD_WORD_DTYPE,
                        device=rows.device)
    scale = torch.empty(nb, 1, dtype=torch.float32, device=rows.device)
    _launch("qsgd_pack", rows, rows.data_ptr(), noise.data_ptr(),
            words.data_ptr(), scale.data_ptr(), nb, levels, bits, epw, nwords,
            WF.qsgd_scale_denominator(levels))
    return words, scale


def qsgd_unpack(words, scale, levels: int):
    """Launch the QSGD unpack of ``(nb, W)`` words and ``(nb, 1)`` scales."""
    nb = words.shape[0]
    bits, epw, nwords = _qsgd_layout(levels)
    out = torch.empty(nb, WF.PACK_BLOCK, dtype=torch.float32,
                      device=words.device)
    _launch("qsgd_unpack", words, words.data_ptr(), scale.data_ptr(),
            out.data_ptr(), nb, bits, epw, nwords)
    return out
