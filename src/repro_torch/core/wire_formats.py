"""Bit-packed wire formats: the one constants module of the packed gossip
payloads (``src/repro/core/wire_formats.py``).

The codec executor (:mod:`repro_torch.core.gossip`), the kernels
(:mod:`repro_torch.kernels.wire_pack`, ``csrc/wire_pack.cu``), their plain
versions (:mod:`repro_torch.kernels.ref`) and the byte model all read the
layout from here:

* ``topk_bits`` -- per PACK_BLOCK window, the ``k = max(round(frac *
  PACK_BLOCK), 1)`` elements above the window's bisection threshold, the
  first k by index: bf16 values and u16 window-local indices, 4 bytes per
  kept element.
* ``qsgd_bits`` -- per window, QSGD codes in ``[0, levels]`` with a sign
  bit, ``bits = ceil(log2(levels + 1)) + 1`` wide, ``32 // bits`` to a
  32-bit word, plus one f32 scale that folds in the 1/(1+omega) contraction.

Wire dtypes in PyTorch: bf16 values are ``torch.bfloat16``; the u16 indices
cross as ``torch.int16`` (indices are below 2048, so the bits and the values
are the reference's); the u32 code words cross as ``torch.int32`` bit
patterns.  torch's unsigned types have few kernels, and the bytes are the
same.

A codec is a :class:`WireFormat`: ``pack(rows, noise=None)`` maps an
``(R, PACK_BLOCK)`` f32 row matrix to its wire buffers (``noise``: the
``(R, PACK_BLOCK)`` f32 U[0, 1) draws of qsgd's stochastic rounding, an
operand, never a generator), ``unpack(*bufs, dtype=f32)`` maps them back to
dense windows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.ref import (qsgd_pack_ref, qsgd_unpack_ref, topk_pack_ref,
                           topk_unpack_ref)

__all__ = ["PACK_BLOCK", "N_BISECT_ITERS", "TOPK_VALUE_DTYPE",
           "TOPK_INDEX_DTYPE", "QSGD_WORD_DTYPE", "WIRE_FORMATS",
           "WIRE_MODES", "WireFormat", "bisect_threshold", "topk_keep",
           "qsgd_bits", "qsgd_elems_per_word", "qsgd_words_per_window",
           "qsgd_window_omega", "qsgd_scale_denominator", "topk_pack_ref",
           "topk_unpack_ref", "qsgd_pack_ref", "qsgd_unpack_ref",
           "make_wire_format", "measured_pack_nbytes",
           "measured_weight_nbytes", "codec_collective_bytes",
           "to_windows", "from_windows"]

# the selection and packing window (16 x 128 lanes on the reference's TPU)
PACK_BLOCK = 2048

# bisection iterations for the top-k threshold (f32 has 24 mantissa bits)
N_BISECT_ITERS = 24

TOPK_VALUE_DTYPE = torch.bfloat16
TOPK_INDEX_DTYPE = torch.int16    # u16 bit patterns; PACK_BLOCK < 2**15
QSGD_WORD_DTYPE = torch.int32     # u32 bit patterns

# spec-level wire knob values (ExperimentSpec.wire)
WIRE_MODES = ("dense", "packed_bits")

# registered payload layouts (one per compressor family)
WIRE_FORMATS = ("topk_bits", "qsgd_bits")


def topk_keep(frac: float) -> int:
    """Kept elements per PACK_BLOCK window at sparsity ``frac``."""
    return max(int(round(frac * PACK_BLOCK)), 1)


def qsgd_bits(levels: int) -> int:
    """Field width: magnitude code in [0, levels] plus one sign bit."""
    return int(np.ceil(np.log2(levels + 1))) + 1


def qsgd_elems_per_word(levels: int) -> int:
    return 32 // qsgd_bits(levels)


def qsgd_words_per_window(levels: int) -> int:
    epw = qsgd_elems_per_word(levels)
    return -(-PACK_BLOCK // epw)


def qsgd_window_omega(levels: int) -> float:
    """QSGD relative variance at the window size (per-window normalization)."""
    return float(min(np.sqrt(PACK_BLOCK) / levels, PACK_BLOCK / levels ** 2))


def qsgd_scale_denominator(levels: int) -> float:
    """``levels * (1 + omega)``, formed in double and rounded to f32 once:
    the reference divides an f32 norm by this Python float."""
    return float(np.float32(levels * (1.0 + qsgd_window_omega(levels))))


def bisect_threshold(a: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row threshold keeping >= k of the magnitudes in ``a``.

    ``a``: non-negative ``(..., m)``; returns ``(...)``.  N_BISECT_ITERS
    halvings of ``[0, max]``: ``mid = 0.5 * (lo + hi)`` in f32, and
    ``count(a >= mid) >= k`` moves ``lo`` up, else ``hi`` down.  A row with
    fewer than k nonzeros ends at ``lo = 0``.
    """
    hi = a.amax(dim=-1)
    lo = torch.zeros_like(hi)
    for _ in range(N_BISECT_ITERS):
        mid = (lo + hi) * 0.5
        up = (a >= mid.unsqueeze(-1)).sum(dim=-1) >= k
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return lo


def to_windows(flat: torch.Tensor) -> torch.Tensor:
    """Pad the last axis to PACK_BLOCK windows: ``(..., d) -> (..., nb,
    PACK_BLOCK)``."""
    d = flat.shape[-1]
    pad = (-d) % PACK_BLOCK
    padded = torch.nn.functional.pad(flat, (0, pad))
    return padded.reshape(*flat.shape[:-1], -1, PACK_BLOCK)


def from_windows(rows: torch.Tensor, d: int, shape=None) -> torch.Tensor:
    """Inverse of :func:`to_windows` for one vector: ``(nb, PACK_BLOCK) ->
    (d,)``, reshaped to ``shape`` when given."""
    out = rows.reshape(-1)[:d]
    return out if shape is None else out.reshape(shape)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One bit-packed payload layout: codec and byte model together.

    name: "topk_bits" | "qsgd_bits".
    deterministic: True when ``pack`` takes no noise (top-k).
    payload_bytes_per_window / overhead_bytes_per_window: the bytes each
      PACK_BLOCK window puts on the wire (overhead: qsgd's f32 scale).
    pack: ``(rows, noise=None) -> wire buffers``.
    unpack: ``(*buffers, dtype=f32) -> (R, PACK_BLOCK)`` dense windows.
    """

    name: str
    deterministic: bool
    payload_bytes_per_window: int
    overhead_bytes_per_window: int
    pack: Callable
    unpack: Callable

    def windows(self, d: int) -> int:
        return -(-int(d) // PACK_BLOCK)

    def payload_bytes(self, d: int) -> float:
        return float(self.windows(d) * self.payload_bytes_per_window)

    def overhead_bytes(self, d: int) -> float:
        return float(self.windows(d) * self.overhead_bytes_per_window)

    def buffer_bytes(self, d: int) -> float:
        """Modeled nbytes of one agent's packed buffers for a d-vector."""
        return self.payload_bytes(d) + self.overhead_bytes(d)


def make_wire_format(compressor_name: str, *, frac: Optional[float] = None,
                     levels: Optional[int] = None,
                     use_kernel: bool = False) -> WireFormat:
    """The wire format of a compressor family.

    ``use_kernel`` routes pack and unpack through the wrappers of
    :mod:`repro_torch.kernels.ops` (the CUDA kernels for CUDA tensors, their
    plain versions for CPU ones); otherwise the plain versions run on any
    device.
    """
    from ..kernels import ops as _ops

    if compressor_name in ("top_k", "block_top_k"):
        if frac is None:
            raise ValueError("topk_bits wire format needs frac")
        k = topk_keep(frac)
        pack_fn = _ops.wire_topk_pack if use_kernel else topk_pack_ref
        unpack_fn = _ops.wire_topk_unpack if use_kernel else topk_unpack_ref

        def pack(rows, noise=None):
            del noise
            return pack_fn(rows, k)

        def unpack(vals, idx, dtype=torch.float32):
            return unpack_fn(vals, idx).to(dtype)

        return WireFormat(
            name="topk_bits", deterministic=True,
            payload_bytes_per_window=4 * k,      # bf16 value + u16 index
            overhead_bytes_per_window=0, pack=pack, unpack=unpack)
    if compressor_name == "qsgd":
        if levels is None:
            raise ValueError("qsgd_bits wire format needs levels")
        pack_fn = _ops.wire_qsgd_pack if use_kernel else qsgd_pack_ref
        unpack_fn = _ops.wire_qsgd_unpack if use_kernel else qsgd_unpack_ref

        def pack(rows, noise=None):
            if noise is None:
                raise ValueError("qsgd_bits packs with its U[0,1) noise")
            return pack_fn(rows, noise, levels)

        def unpack(word, scale, dtype=torch.float32):
            return unpack_fn(word, scale, levels).to(dtype)

        return WireFormat(
            name="qsgd_bits", deterministic=False,
            payload_bytes_per_window=4 * qsgd_words_per_window(levels),
            overhead_bytes_per_window=4,         # one f32 scale per window
            pack=pack, unpack=unpack)
    raise ValueError(
        f"compressor {compressor_name!r} has no registered bit-packed wire "
        f"format; have {WIRE_FORMATS} (top_k/block_top_k -> topk_bits, "
        "qsgd -> qsgd_bits)")


@functools.lru_cache(maxsize=None)
def measured_pack_nbytes(fmt: WireFormat, d: int) -> int:
    """nbytes of the buffers ``fmt.pack`` actually returns for a d-vector:
    its windows are packed (zeros, on the CPU, where the kernel wrappers run
    their plain versions, which return the kernels' dtypes and shapes) and
    the buffers measured.  The layout constants of :class:`WireFormat` are
    the model this is checked against."""
    rows = torch.zeros(fmt.windows(d), PACK_BLOCK)
    bufs = fmt.pack(rows, None if fmt.deterministic else torch.zeros_like(rows))
    return sum(b.numel() * b.element_size() for b in bufs)


@functools.lru_cache(maxsize=None)
def measured_weight_nbytes(fmt: WireFormat) -> int:
    """nbytes one push-sum weight adds to an agent's buffers: the codec
    executor bit-casts the exact f32 weight into words of the last
    buffer's dtype (measured by packing one window, as
    :func:`measured_pack_nbytes` does)."""
    rows = torch.zeros(1, PACK_BLOCK)
    bufs = fmt.pack(rows, None if fmt.deterministic else torch.zeros_like(rows))
    itemsize = bufs[-1].element_size()
    if itemsize not in (2, 4):
        raise ValueError(f"no push-sum weight word layout for a "
                         f"{itemsize}-byte wire buffer dtype")
    return (4 // itemsize) * itemsize


def codec_collective_bytes(fmt: WireFormat, mode: str, n_agents: int,
                           d: int) -> float:
    """Per-round link bytes for one agent buffer under a codec executor:
    'ring' ships each agent's packed buffers to its live neighbors (one
    shift at n=2, else two); 'packed' all-gathers every agent's buffers."""
    per_agent = fmt.buffer_bytes(d)
    if mode == "ring":
        shifts = 1.0 if n_agents == 2 else 2.0
        return shifts * per_agent
    if mode == "packed":
        return float(n_agents) * per_agent
    raise ValueError(f"no codec wire accounting for gossip mode {mode!r}")
