"""Public wrappers of the port's kernels: checks, dispatch, launch counts.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only because its tensors lie on the CPU.  For CUDA tensors it launches the
hand-written kernel or raises: there is no fallback.  Each launch adds one
to its kernel's entry in :data:`LAUNCHES` (``sr_cast`` and ``sr_cast_leaf``
both launch the ``sr_cast`` kernel), so a run can show that its main path
went through the kernels (``chip_smoke.py`` zeroes the counts before the
path and reads them after).

Operand types of the ef updates, as the comm-round engine issues them: all
f32; ``ef_track`` with every operand bf16; ``ef_step`` / ``ef_gossip`` with
bf16 EF operands beside an f32 ``x`` / ``y``.  ``out_dtype`` is None (each
output in its state operand's dtype) or f32 (all three, for the
stochastic-rounding writeback).
"""

from __future__ import annotations

import torch

from . import ef_update as _ef
from . import ref
from . import sr_cast as _srk
from .flatten import TILE

__all__ = ["LAUNCHES", "reset_launches", "ef_track", "ef_step", "ef_gossip",
           "sr_cast", "sr_cast_leaf"]

LAUNCHES = {"ef_track": 0, "ef_step": 0, "ef_gossip": 0, "sr_cast": 0}

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


def ef_track(q, m, v, c, wc, g, gp, gamma: float, out_dtype=None):
    """Fused Algorithm-1 lines 11-12: returns (q + c, m + wc, v')."""
    if _check_ef("ef_track", (q, m, v, c, wc, g, gp), out_dtype) == "cpu":
        return ref.ef_track_ref(q, m, v, c, wc, g, gp, gamma, out_dtype)
    out = _ef.ef_track(q, m, v, c, wc, g, gp, gamma, out_dtype is not None)
    LAUNCHES["ef_track"] += 1
    return out


def ef_step(q, m, x, c, wc, v, gamma: float, eta: float, out_dtype=None):
    """Fused Algorithm-1 lines 13-14: returns (q + c, m + wc, x')."""
    if _check_ef("ef_step", (q, m, x, c, wc, v), out_dtype) == "cpu":
        return ref.ef_step_ref(q, m, x, c, wc, v, gamma, eta, out_dtype)
    out = _ef.ef_step(q, m, x, c, wc, v, gamma, eta, out_dtype is not None)
    LAUNCHES["ef_step"] += 1
    return out


def ef_gossip(q, m, y, c, wc, gamma: float, scale: float = 1.0,
              out_dtype=None):
    """Fused CHOCO / SoteriaFL round: returns (q + s*c, m + s*wc, y')."""
    if _check_ef("ef_gossip", (q, m, y, c, wc), out_dtype) == "cpu":
        return ref.ef_gossip_ref(q, m, y, c, wc, gamma, scale, out_dtype)
    out = _ef.ef_gossip(q, m, y, c, wc, gamma, scale, out_dtype is not None)
    LAUNCHES["ef_gossip"] += 1
    return out


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
