"""Plain PyTorch versions of the fused kernels.

They are the CPU path of :mod:`repro_torch.kernels.ops`, and the versions
the CUDA kernels are held against, bitwise, on the card (``chip_smoke.py``).
Each keeps the reference's order of operations
(``src/repro/kernels/ef_update.py``, ``src/repro/kernels/sr_cast.py``): f32
arithmetic, one op at a time, so no step is fused into an FMA.

``out_dtype`` (the ef updates): ``None`` writes each output in its state
operand's dtype; a dtype (the engine asks for f32) writes all three in it,
for the stochastic-rounding writeback to take over.
"""

from __future__ import annotations

import torch

__all__ = ["ef_track_ref", "ef_step_ref", "ef_gossip_ref", "sr_cast_ref"]

_F32 = torch.float32


def _outs(states, values, out_dtype):
    return tuple(v.to(s.dtype if out_dtype is None else out_dtype)
                 for s, v in zip(states, values))


def ef_track_ref(q, m, v, c, wc, g, gp, gamma: float, out_dtype=None):
    q2 = q.to(_F32) + c.to(_F32)
    m2 = m.to(_F32) + wc.to(_F32)
    v2 = v.to(_F32) + gamma * (m2 - q2) + g.to(_F32) - gp.to(_F32)
    return _outs((q, m, v), (q2, m2, v2), out_dtype)


def ef_step_ref(q, m, x, c, wc, v, gamma: float, eta: float, out_dtype=None):
    q2 = q.to(_F32) + c.to(_F32)
    m2 = m.to(_F32) + wc.to(_F32)
    x2 = x.to(_F32) + gamma * (m2 - q2) - eta * v.to(_F32)
    return _outs((q, m, x), (q2, m2, x2), out_dtype)


def ef_gossip_ref(q, m, y, c, wc, gamma: float, scale: float = 1.0,
                  out_dtype=None):
    q2 = q.to(_F32) + scale * c.to(_F32)
    m2 = m.to(_F32) + scale * wc.to(_F32)
    y2 = y.to(_F32) + gamma * (m2 - q2)
    return _outs((q, m, y), (q2, m2, y2), out_dtype)


def sr_cast_ref(x, bits):
    """Stochastic rounding f32 -> bf16: ``high16(bits(x) + (r & 0xFFFF))``.

    ``bits``: int32 of ``x``'s shape (the reference's u32 words, same bit
    patterns); only the low 16 bits are read.  The sum is formed in int32,
    whose two's-complement wrap is the reference's mod-2^32 arithmetic; the
    arithmetic shift then leaves the same low 16 bits as a logical one, and
    they fit int16 exactly, so ``.view(bfloat16)`` gives the reference's
    bits.
    """
    if x.shape != bits.shape:
        raise ValueError(f"sr_cast shape mismatch: {tuple(x.shape)} vs "
                         f"{tuple(bits.shape)}")
    word = x.to(_F32).contiguous().view(torch.int32) + (bits & 0xFFFF)
    return (word >> 16).to(torch.int16).view(torch.bfloat16)
