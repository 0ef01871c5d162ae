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

Donation (``donate=True``, the reference's ``donate_argnums``): each
round's old state gives its memory back as soon as the step has returned
the new one.  Without it a round keeps three states alive, the chunk's
first (held by the caller and by :func:`run_chunked`), the current one and
the new one; a full-width LM's four-agent state is 14-25 GB.  The old
state's tensors that the new state does not share have their storage
released (``untyped_storage().resize_(0)``), so after the call only the
returned state is valid, as in the reference: the caller must not read
the state it passed in, nor a parameter tree the algorithm's ``init``
placed in it uncopied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, Tuple

import numpy as np
import torch

from ..tree import tree_leaves

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


def _storages(state):
    return [t.untyped_storage() for t in tree_leaves(state)
            if isinstance(t, torch.Tensor)]


def _donate(old, new) -> None:
    """Release the storage of every tensor of ``old`` whose storage no
    tensor of ``new`` shares (the module docstring's donation)."""
    keep = {st.data_ptr() for st in _storages(new)}
    for st in _storages(old):
        if st.nbytes() and st.data_ptr() not in keep:
            st.resize_(0)


@dataclasses.dataclass(frozen=True)
class ChunkRunner:
    """``(state, seed, start) -> (state, seed, stacked metrics)`` over
    ``chunk`` rounds of ``algo.step``; with ``donate`` every round's old
    state is released once the new one exists."""

    algo: Any
    source: BatchSource
    chunk: int
    donate: bool = False

    def __call__(self, state, seed: int, start: int = 0):
        device = self.algo.device
        per_round = []
        for t in range(start, start + self.chunk):
            gen_batch, gen_step = round_generators(seed, t, device)
            batch = self.source(gen_batch, t)
            new, metrics = self.algo.step(state, batch, gen_step)
            if self.donate:
                _donate(state, new)
            state = new
            per_round.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]}
        return state, seed, stacked


def make_runner(algo, source: BatchSource, chunk: int,
                donate: bool = False) -> ChunkRunner:
    """A runner over ``chunk`` rounds of ``algo.step``; ``algo`` is a built
    :class:`~repro_torch.core.registry.Algorithm` (it names the device)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return ChunkRunner(algo=algo, source=source, chunk=chunk, donate=donate)


def run_chunked(algo, source: BatchSource, state, seed: int, steps: int, *,
                chunk: int, start: int = 0,
                on_chunk: Optional[Callable] = None,
                donate: bool = False) -> Tuple[Any, int]:
    """Run rounds ``[start, steps)`` in chunks of ``chunk``.

    ``on_chunk(t0, t1, state, metrics)`` fires at every chunk boundary with
    the post-chunk state and the stacked (length ``t1 - t0``) metrics, still
    device tensors, so the callback decides when to sync; under ``donate``
    that state stays valid until the next chunk runs.  Returning ``False``
    stops the run there.  Returns the final ``(state, seed)``.
    """
    t = start
    while t < steps:
        size = min(chunk, steps - t)
        state, seed, metrics = make_runner(algo, source, size, donate)(
            state, seed, t)
        t += size
        if on_chunk is not None and on_chunk(t - size, t, state,
                                             metrics) is False:
            break
    return state, seed
