"""Launcher for the per-window top-k kernel (``csrc/block_topk.cu``).

Hand-written Hopper replacement of the Pallas kernel
``src/repro/kernels/block_topk.py::block_topk``: keep the k largest
magnitudes of each 2048-element window of an f32 or bf16 ``(nb, 2048)``
operand and write +0.0 elsewhere.

Ties.  The kernel keeps exactly k: every magnitude above the k-th largest,
then the ones equal to it in index order until k are kept -- the set of
``jax.lax.top_k`` (ties to the lower index), of the reference's
``block_top_k`` compressor and of its oracle ``ref.block_topk_ref``, so the
output is bitwise :func:`repro_torch.kernels.ref.block_topk_ref`'s.  The TPU
kernel keeps every element at or above a bisection threshold on the values
(``src/repro/kernels/block_topk.py:104-109``), so on exact ties it keeps
more than k; the port has no such option.  NaN magnitudes are out of
contract.

This function only allocates and launches: operand checks, the CPU
dispatch and the launch counter live in :mod:`repro_torch.kernels.ops`.
The library is built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["block_topk"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("block_topk")
    lib.block_topk.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p]
    lib.block_topk.restype = ctypes.c_int
    return lib


def block_topk(windows, k: int):
    """Launch the top-k of contiguous ``(nb, 2048)`` windows."""
    out = torch.empty_like(windows)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        err = _lib().block_topk(windows.data_ptr(),
                                int(windows.dtype == torch.bfloat16),
                                out.data_ptr(), windows.shape[0], k, stream)
    if err != 0:
        raise RuntimeError(f"block_topk launch failed with CUDA error {err}")
    return out
