"""Launcher for the stochastic-rounding cast kernel (``csrc/sr_cast.cu``).

Hand-written Hopper replacement of the Pallas kernel
``src/repro/kernels/sr_cast.py::sr_cast``: f32 -> bf16 with
``high16(bits(x) + (r & 0xFFFF))``, the random words ``r`` an int32 operand
of ``x``'s shape.  Bandwidth-bound (10 B per element).  This function only
launches: checks, the CPU dispatch and the launch counter live in
:mod:`repro_torch.kernels.ops`.  The library is built and loaded on the
first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["sr_cast"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sr_cast")
    lib.sr_cast.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                    ctypes.c_void_p]
    lib.sr_cast.restype = ctypes.c_int
    return lib


def sr_cast(x, bits):
    """Launch the SR cast of contiguous f32 ``x`` with int32 ``bits``."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().sr_cast(x.data_ptr(), bits.data_ptr(), out.data_ptr(),
                             x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"sr_cast launch failed with CUDA error {err}")
    return out
