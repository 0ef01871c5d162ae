"""Chunked training runtime: rounds in chunks, metrics kept on the device.

* :class:`BatchSource` -- the data contract: ``(gen, step_index) -> batch``,
  drawing on the device from the round's generator
  (:mod:`repro_torch.data.batch_source`).
* :func:`make_runner` -- a runner over ``chunk`` calls of ``algo.step``,
  which returns the chunk's metrics stacked as device tensors: nothing in a
  chunk waits for the device.
* :func:`run_chunked` -- drives a ``[start, steps)`` horizon chunk by chunk
  with a boundary callback.

Generator contract (the reference's key-stream contract,
``src/repro/launch/runtime.py``): round ``t``'s two generators, one for
the batch and one for the step, are seeded from a pure function of the
base seed and the absolute round index, so the trajectory does not depend
on the chunking and a resumed run continues the stream instead of
replaying earlier rounds' DP noise.

The reference donates the carried state to its compiled chunk; PyTorch
runs eagerly, and each round's old buffers are freed as soon as the next
state replaces them, so there is no donation to manage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, Tuple

import numpy as np
import torch

__all__ = ["BatchSource", "ChunkRunner", "round_generators", "make_runner",
           "run_chunked"]


class BatchSource(Protocol):
    """Batch synthesis on the device: ``(gen, step_index) -> batch`` with a
    leading ``n_agents`` dim; ``gen`` is the round's batch generator."""

    def __call__(self, gen: torch.Generator, step: int) -> Any: ...


def round_generators(seed: int, t: int, device) -> Tuple[torch.Generator,
                                                         torch.Generator]:
    """Round ``t``'s (batch, step) generators on ``device``: a pure function
    of ``(seed, t)``."""
    s_batch, s_step = np.random.SeedSequence([seed, t]).generate_state(
        2, dtype=np.uint64)
    gens = []
    for s in (s_batch, s_step):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(s) >> 1)
        gens.append(gen)
    return gens[0], gens[1]


@dataclasses.dataclass(frozen=True)
class ChunkRunner:
    """``(state, seed, start) -> (state, seed, stacked metrics)`` over
    ``chunk`` rounds of ``algo.step``."""

    algo: Any
    source: BatchSource
    chunk: int

    def __call__(self, state, seed: int, start: int = 0):
        device = self.algo.device
        per_round = []
        for t in range(start, start + self.chunk):
            gen_batch, gen_step = round_generators(seed, t, device)
            batch = self.source(gen_batch, t)
            state, metrics = self.algo.step(state, batch, gen_step)
            per_round.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]}
        return state, seed, stacked


def make_runner(algo, source: BatchSource, chunk: int) -> ChunkRunner:
    """A runner over ``chunk`` rounds of ``algo.step``; ``algo`` is a built
    :class:`~repro_torch.core.registry.Algorithm` (it names the device)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return ChunkRunner(algo=algo, source=source, chunk=chunk)


def run_chunked(algo, source: BatchSource, state, seed: int, steps: int, *,
                chunk: int, start: int = 0,
                on_chunk: Optional[Callable] = None) -> Tuple[Any, int]:
    """Run rounds ``[start, steps)`` in chunks of ``chunk``.

    ``on_chunk(t0, t1, state, metrics)`` fires at every chunk boundary with
    the post-chunk state and the stacked (length ``t1 - t0``) metrics, still
    device tensors, so the callback decides when to sync.  Returning
    ``False`` stops the run there.  Returns the final ``(state, seed)``.
    """
    t = start
    while t < steps:
        size = min(chunk, steps - t)
        state, seed, metrics = make_runner(algo, source, size)(state, seed, t)
        t += size
        if on_chunk is not None and on_chunk(t - size, t, state,
                                             metrics) is False:
            break
    return state, seed
