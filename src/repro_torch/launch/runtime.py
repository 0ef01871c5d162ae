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

Agents as processes: with an algorithm built under an agent group
(:func:`repro_torch.api.build` ``group=``), every rank runs this same loop
with the same seed.  Its generators are the one-card run's, its batch
source draws the one-card batch and keeps the rank's rows, its step reduces
the metrics over the group, so every rank's metrics are the whole run's.
:func:`gather_state` assembles the one-card state from the ranks' rows.

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

from ..core.gossip import gather_blocks
from ..tree import tree_flatten, tree_leaves

__all__ = ["BatchSource", "ChunkRunner", "round_generators", "make_runner",
           "run_chunked", "gather_state"]


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


def gather_state(state, group, specs=None):
    """The one-card state from every rank's agent rows: each tensor of
    ``state`` (this rank's ``(k, ...)`` block: one agent, or a fleet's k =
    n / ranks) all-gathered in one collective and joined rank-major along
    its agent axis, on every rank; the round counter and other non-tensors
    as they are.  On a grid with a model axis ``specs`` (the
    parameters' tree of :class:`repro_torch.nn.module.Spec`, one replica's)
    says which leaves of each parameter-shaped field of ``state`` are
    sharded: those are then all-gathered over ``'model'`` (one more
    collective) and joined along their sharded dimension."""
    leaves, treedef = tree_flatten(state)
    idx = [i for i, leaf in enumerate(leaves)
           if isinstance(leaf, torch.Tensor)]
    for i, f in zip(idx, gather_blocks(group, [leaves[i] for i in idx])):
        leaves[i] = f
    if specs is None or getattr(group, "model_size", 1) == 1:
        return treedef.unflatten(leaves)
    dims = _field_dims(state, specs)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    parts = group.all_gather([leaves[i] for i in sharded], axis="model")
    for i, p in zip(sharded, parts):
        leaves[i] = torch.cat(list(p.unbind(0)), dim=dims[i] + 1)
    return treedef.unflatten(leaves)


def _field_dims(state, specs):
    """Per leaf of ``state``: the model-sharded dimension of its one-
    replica leaf for the fields shaped like the parameters, else None;
    a nested state (porter-adam's and clip21's ``base``) field by field."""
    spec_leaves, spec_def = tree_flatten(specs)
    fields = state if isinstance(state, tuple) else (state,)
    dims = []
    for field in fields:
        leaves, tdef = tree_flatten(field)
        if tdef == spec_def:
            dims += [s.model_dim for s in spec_leaves]
        elif hasattr(field, "_fields"):
            dims += _field_dims(field, specs)
        else:
            dims += [None] * len(leaves)
    return dims
