"""Launcher for the Mamba2 SSD chunked-scan CUDA kernel (``csrc/ssd_chunk.cu``).

The hand-written Hopper replacement of the Pallas kernel
``src/repro/kernels/ssd_chunk.py::ssd_chunk``: per (batch, head) pair, the
SSD recurrence with a scalar per-step decay

    h_t = exp(dla_t) h_{t-1} + xh_t B_t^T          h in R^{P x N}
    y_t = h_t C_t

over chunks of ``ref.SSD_CHUNK`` tokens, with the f32 state kept on chip
from chunk to chunk, its products on the tensor cores.  It reads xh ``(B,
S, H, P)`` and dla ``(B, S, H)`` in place, and B / C ``(B, S, N)`` through
their batch and time strides (unit stride on N), so the model's column
slices need no copy.  It is instantiated for head and state widths of
:data:`WIDTHS`; any P and N in [1, 64] run in the smallest width that
holds them, zero-padded on chip.  This function
only allocates and launches: operand checks, the CPU dispatch and the
launch counter live in :mod:`repro_torch.kernels.ops`.  The library is
built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["WIDTHS", "ssd_chunk"]

WIDTHS = (16, 32, 64)   # the P and N widths the kernel is instantiated for

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    lib.ssd_chunk.argtypes = [_P] * 7 + [_I] * 5 + [_L, _L, _I, _P]
    lib.ssd_chunk.restype = ctypes.c_int
    return lib


def ssd_chunk(xh, bmat, cmat, dla, h0):
    """Launch the scan; returns (y ``(B, S, H, P)`` f32, h_final
    ``(B, H, P, N)`` f32).  xh, dla, h0: contiguous f32; bmat, cmat: bf16
    or f32 with the same strides, unit stride on N."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    y = torch.empty(xh.shape, dtype=torch.float32, device=xh.device)
    h_fin = torch.empty(h0.shape, dtype=torch.float32, device=xh.device)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _lib().ssd_chunk(
            xh.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dla.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(), b, s, h, p, n,
            bmat.stride(0), bmat.stride(1),
            int(bmat.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed with CUDA error {err}")
    return y, h_fin
