"""Launchers for the fused error-feedback CUDA kernels (``csrc/ef_update.cu``).

Hand-written Hopper replacements of the Pallas kernels in
``src/repro/kernels/ef_update.py``:

    ef_track:  q += c; m += wc; v = v + gamma*(m - q) + g - gp   (lines 11-12)
    ef_step:   q += c; m += wc; x = x + gamma*(m - q) - eta*v    (lines 13-14)

Both run over the flat f32 planes of :mod:`repro_torch.kernels.flatten`, one
launch for every (agent, leaf) pair, and are bandwidth-bound (40 and 36
bytes moved per element).  These functions only launch: operand checks,
the CPU dispatch and the launch counters live in :mod:`repro_torch.kernels.ops`.
The library is built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["ef_track", "ef_step"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "ef_track_f32": [_P] * 10 + [ctypes.c_float, ctypes.c_int64, _P],
    "ef_step_f32": [_P] * 9 + [ctypes.c_float, ctypes.c_float,
                               ctypes.c_int64, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ef_update")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(fn_name: str, inputs, scalars):
    lead = inputs[0]
    outs = tuple(torch.empty_like(lead) for _ in range(3))
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream(lead.device).cuda_stream
        err = getattr(_lib(), fn_name)(
            *(t.data_ptr() for t in inputs), *(o.data_ptr() for o in outs),
            *scalars, lead.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {err}")
    return outs


def ef_track(q, m, v, c, wc, g, gp, gamma: float):
    """Launch the fused track kernel; returns new (q, m, v) planes."""
    return _launch("ef_track_f32", (q, m, v, c, wc, g, gp), (float(gamma),))


def ef_step(q, m, x, c, wc, v, gamma: float, eta: float):
    """Launch the fused step kernel; returns new (q, m, x) planes."""
    return _launch("ef_step_f32", (q, m, x, c, wc, v),
                   (float(gamma), float(eta)))
