"""Public wrappers of the port's kernels: checks, dispatch, launch counts.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only because its tensors lie on the CPU.  For CUDA tensors it launches the
hand-written kernel or raises: there is no fallback.  Each launch adds one
to the wrapper's entry in :data:`LAUNCHES`, so a run can show that its main
path went through the kernels (``chip_smoke.py`` zeroes the counts before
the path and reads them after).

This slice is f32 only: bf16 planes and the ``out_dtype`` override arrive
with the stochastic-rounding (``sr_cast``) slice.
"""

from __future__ import annotations

import torch

from . import ef_update as _ef
from . import ref

__all__ = ["LAUNCHES", "reset_launches", "ef_track", "ef_step"]

LAUNCHES = {"ef_track": 0, "ef_step": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, tensors) -> str:
    """Validate same-shape contiguous f32 operands on one device; returns
    the device type."""
    lead = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} takes f32 planes in this slice, got {t.dtype}; bf16 "
                "planes come with the sr_cast slice")
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


def ef_track(q, m, v, c, wc, g, gp, gamma: float):
    """Fused Algorithm-1 lines 11-12: returns (q + c, m + wc, v')."""
    if _check("ef_track", (q, m, v, c, wc, g, gp)) == "cpu":
        return ref.ef_track_ref(q, m, v, c, wc, g, gp, gamma)
    out = _ef.ef_track(q, m, v, c, wc, g, gp, gamma)
    LAUNCHES["ef_track"] += 1
    return out


def ef_step(q, m, x, c, wc, v, gamma: float, eta: float):
    """Fused Algorithm-1 lines 13-14: returns (q + c, m + wc, x')."""
    if _check("ef_step", (q, m, x, c, wc, v)) == "cpu":
        return ref.ef_step_ref(q, m, x, c, wc, v, gamma, eta)
    out = _ef.ef_step(q, m, x, c, wc, v, gamma, eta)
    LAUNCHES["ef_step"] += 1
    return out
