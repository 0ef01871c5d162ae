"""Launchers for the fused error-feedback CUDA kernels (``csrc/ef_update.cu``).

Hand-written Hopper replacements of the Pallas kernels in
``src/repro/kernels/ef_update.py``:

    ef_track:   q += c;   m += wc;   v = v + gamma*(m - q) + g - gp  (11-12)
    ef_step:    q += c;   m += wc;   x = x + gamma*(m - q) - eta*v   (13-14)
    ef_gossip:  q += s*c; m += s*wc; y = y + gamma*(m - q)   (CHOCO, Soteria)

All three run over the flat planes of :mod:`repro_torch.kernels.flatten`,
one launch for every (agent, leaf) pair, with f32 or bf16 operands (slot 2,
the ``v`` / ``x`` / ``y`` operand, may be f32 beside bf16 EF operands) and
outputs in each state's dtype or all f32.  A bf16 output given a plane of
int32 random words (``words``) is rounded stochastically in the kernel's
epilogue, as ``sr_cast`` would round the f32 output.  They are
bandwidth-bound.  These functions only launch: operand checks, the CPU
dispatch and the launch counters live in :mod:`repro_torch.kernels.ops`.
The library is built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["ef_track", "ef_step", "ef_gossip"]

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_TAIL = [ctypes.c_int64, _I, _I, _I, _P]  # n, ef_bf16, y_bf16, out_f32, stream
# operands, then 3 outputs and 3 word planes, then the scalars
_SIGNATURES = {
    "ef_track": [_P] * 13 + [_F] + _TAIL,
    "ef_step": [_P] * 12 + [_F, _F] + _TAIL,
    "ef_gossip": [_P] * 11 + [_F, _F] + _TAIL,
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ef_update")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(fn_name: str, inputs, scalars, out_f32: bool, words):
    """``inputs`` in kernel order; slot 2 is the y slot.  Outputs are f32
    when ``out_f32``, else in the dtypes of inputs 0-2; ``words``: None or
    per output an int32 plane (the output is then bf16, rounded
    stochastically) or None."""
    lead = inputs[0]
    words = (None,) * 3 if words is None else tuple(words)
    outs = tuple(torch.empty(lead.shape, device=lead.device,
                             dtype=(torch.bfloat16 if w is not None
                                    else torch.float32 if out_f32
                                    else t.dtype))
                 for t, w in zip(inputs[:3], words))
    ef_bf16 = int(lead.dtype == torch.bfloat16)
    y_bf16 = int(inputs[2].dtype == torch.bfloat16)
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream(lead.device).cuda_stream
        err = getattr(_lib(), fn_name)(
            *(t.data_ptr() for t in inputs), *(o.data_ptr() for o in outs),
            *(None if w is None else w.data_ptr() for w in words),
            *scalars, lead.numel(), ef_bf16, y_bf16, int(out_f32), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {err}")
    return outs


def ef_track(q, m, v, c, wc, g, gp, gamma: float, out_f32: bool = False,
             words=None):
    """Launch the fused track kernel; returns new (q, m, v) planes."""
    return _launch("ef_track", (q, m, v, c, wc, g, gp), (float(gamma),),
                   out_f32, words)


def ef_step(q, m, x, c, wc, v, gamma: float, eta: float,
            out_f32: bool = False, words=None):
    """Launch the fused step kernel; returns new (q, m, x) planes."""
    return _launch("ef_step", (q, m, x, c, wc, v),
                   (float(gamma), float(eta)), out_f32, words)


def ef_gossip(q, m, y, c, wc, gamma: float, scale: float = 1.0,
              out_f32: bool = False, words=None):
    """Launch the fused gossip kernel; returns new (q, m, y) planes."""
    return _launch("ef_gossip", (q, m, y, c, wc),
                   (float(gamma), float(scale)), out_f32, words)
