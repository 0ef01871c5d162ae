"""Launcher for the RWKV6 chunked-scan CUDA kernel (``csrc/rwkv6_chunk.cu``).

The hand-written Hopper replacement of the Pallas kernel
``src/repro/kernels/rwkv6_chunk.py::rwkv6_chunk``: per (batch, head) pair,
the RWKV6 recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t

over chunks of ``ref.RWKV_CHUNK`` tokens, with the f32 state kept on chip from
chunk to chunk, its products on the tensor cores.  It reads the ``(B, S, H,
N)`` layout in place.  It is instantiated for head dims of :data:`WIDTHS`;
any N in [1, 64] runs in the smallest width that holds it, zero-padded on
chip.  This function only allocates and launches: operand checks, the CPU dispatch and
the launch counter live in :mod:`repro_torch.kernels.ops`.  The library is
built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["WIDTHS", "rwkv6_chunk"]

WIDTHS = (16, 32, 64)   # the head dims the kernel is instantiated for

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv6_chunk")
    lib.rwkv6_chunk.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.rwkv6_chunk.restype = ctypes.c_int
    return lib


def rwkv6_chunk(r, k, v, logw, u, s0):
    """Launch the scan; returns (o ``(B, S, H, N)`` f32, s_final
    ``(B, H, N, N)`` f32).  r, k, v: contiguous bf16 or f32; logw, u, s0:
    contiguous f32."""
    b, s, h, n = r.shape
    o = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_fin = torch.empty(s0.shape, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().rwkv6_chunk(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
            b, s, h, n, int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_chunk launch failed with CUDA error {err}")
    return o, s_fin
