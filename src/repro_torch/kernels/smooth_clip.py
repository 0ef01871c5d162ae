"""Launchers for the smooth-clip kernels (``csrc/smooth_clip.cu``).

Hand-written Hopper replacements of the Pallas kernels in
``src/repro/kernels/smooth_clip.py``, over a flat ``(tiles, 8192)`` plane
of f32 or bf16 whose logical rows hold ``tiles_per_row`` tiles each:

    clip:         y = x * f_row (+ sigma * z), f_row = tau / (tau + ||row||),
                  in one launch (partials and factors written on the way)
    mean_noise:   y[g] = mean_s x[g, s] (+ sigma * z[g]), each group's
                  sample mean (and its DP perturbation), f32 out; a kernel
                  of the port alone (the reference adds the noise in jnp);
                  over chunks of samples, the running sum of the earlier
                  chunks in and the raw sum out until the last chunk
    sumsq:        per-tile sum of squares, in a fixed order -> (tiles,) f32
    scale:        y = x * f_row, one f32 factor per logical row
    scale_noise:  y = x * f_row + sigma * z

These functions only allocate and launch: operand checks, the CPU dispatch
and the launch counters live in :mod:`repro_torch.kernels.ops`.  The
library is built and loaded on the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["clip", "clip_plan", "mean_noise", "sumsq", "scale"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "clip_sumsq": [_P, _I, _P, _I64, _P],
    "clip_scale": [_P, _I, _P, _I64, _P, ctypes.c_float, _P, _I64, _P],
    "clip_fused": [_P, _I, _P, ctypes.c_float, ctypes.c_float, _P, _P, _P,
                   _I64, _I64, _P],
    "clip_plan": [_I, _I, _I64, _I64, _P],
    "clip_mean_noise": [_P, _I, _P, _P, _I, ctypes.c_float, _P, _I64,
                        _I64, _I64, _I64, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("smooth_clip")
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


def clip(planes, rows: int, tau: float, noise=None, sigma: float = 0.0):
    """Launch the fused smooth clip of a contiguous ``(rows * T, TILE)``
    plane (``+ sigma * noise``); returns (the clipped plane, the
    ``(rows * T,)`` f32 partials, the ``(rows,)`` f32 factors)."""
    tiles = planes.shape[0]
    out = torch.empty_like(planes)
    partials = torch.empty(tiles, dtype=torch.float32, device=planes.device)
    factors = torch.empty(rows, dtype=torch.float32, device=planes.device)
    _launch("clip_fused", planes, planes.data_ptr(),
            int(planes.dtype == torch.bfloat16),
            None if noise is None else noise.data_ptr(), float(sigma),
            float(tau), out.data_ptr(), partials.data_ptr(),
            factors.data_ptr(), tiles, tiles // rows)
    return out, partials, factors


def clip_plan(planes, rows: int, noisy: bool = False) -> dict:
    """The route :func:`clip` takes on the card for ``planes`` of ``rows``
    logical rows: ``cluster`` (a thread block cluster a row of at most 8
    tiles) or ``cooperative`` (one cooperative launch with a grid-wide
    barrier); the grid and the tiles a CTA.  Launches nothing."""
    plan = (ctypes.c_int64 * 3)()
    with torch.cuda.device(planes.device):
        err = _lib().clip_plan(int(planes.dtype == torch.bfloat16),
                               int(noisy), planes.shape[0],
                               planes.shape[0] // rows, plan)
    if err != 0:
        raise RuntimeError(f"clip_plan failed with CUDA error {err}")
    return {"route": ("cooperative", "cluster")[plan[0]], "grid": plan[1],
            "tiles_per_cta": plan[2]}


def mean_noise(planes, groups: int, b: int, noise=None, sigma: float = 0.0,
               acc=None, finish: bool = True, b_total=None):
    """Launch the sample mean of a contiguous ``(groups * b * T, TILE)``
    plane of clipped samples (group g's sample s is logical row ``g * b +
    s``), plus ``sigma`` times the f32 ``(groups * T, TILE)`` ``noise``
    when given; the sum starts from the f32 running sum ``acc`` (a plane
    of the output's shape) when given, and ``finish=False`` returns that
    sum without the product with ``RN(1 / b_total)`` (``b_total``: b when
    None).  Returns the f32 ``(groups * T, TILE)`` plane."""
    out = torch.empty((planes.shape[0] // b, planes.shape[1]),
                      dtype=torch.float32, device=planes.device)
    _launch("clip_mean_noise", planes, planes.data_ptr(),
            int(planes.dtype == torch.bfloat16),
            None if noise is None else noise.data_ptr(),
            None if acc is None else acc.data_ptr(), int(finish),
            float(sigma), out.data_ptr(), groups, b,
            b if b_total is None else b_total, out.shape[0] // groups)
    return out


def sumsq(planes):
    """Launch the per-tile sum of squares of a contiguous plane."""
    tiles = planes.shape[0]
    out = torch.empty(tiles, dtype=torch.float32, device=planes.device)
    _launch("clip_sumsq", planes, planes.data_ptr(),
            int(planes.dtype == torch.bfloat16), out.data_ptr(), tiles)
    return out


def scale(planes, factor, noise=None, sigma: float = 0.0):
    """Launch ``planes * factor[row]`` (``+ sigma * noise``); ``factor``
    holds one f32 per logical row of ``planes.shape[0] // len(factor)``
    tiles."""
    tiles = planes.shape[0]
    out = torch.empty_like(planes)
    _launch("clip_scale", planes, planes.data_ptr(),
            int(planes.dtype == torch.bfloat16), factor.data_ptr(),
            tiles // factor.shape[0],
            None if noise is None else noise.data_ptr(), float(sigma),
            out.data_ptr(), tiles)
    return out
