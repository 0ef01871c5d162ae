"""Plain PyTorch versions of the fused kernels.

They are the CPU path of :mod:`repro_torch.kernels.ops`, and the versions
the CUDA kernels are held against, bitwise, on the card (``chip_smoke.py``).
Each keeps the reference's order of operations
(``src/repro/kernels/ef_update.py``): f32 arithmetic, one op at a time, so
no step is fused into an FMA.
"""

from __future__ import annotations

import torch

__all__ = ["ef_track_ref", "ef_step_ref"]


def ef_track_ref(q, m, v, c, wc, g, gp, gamma: float):
    f = torch.float32
    q2 = q.to(f) + c.to(f)
    m2 = m.to(f) + wc.to(f)
    v2 = v.to(f) + gamma * (m2 - q2) + g.to(f) - gp.to(f)
    return q2.to(q.dtype), m2.to(m.dtype), v2.to(v.dtype)


def ef_step_ref(q, m, x, c, wc, v, gamma: float, eta: float):
    f = torch.float32
    q2 = q.to(f) + c.to(f)
    m2 = m.to(f) + wc.to(f)
    x2 = x.to(f) + gamma * (m2 - q2) - eta * v.to(f)
    return q2.to(q.dtype), m2.to(m.dtype), x2.to(x.dtype)
