"""Batch sources on the device: ``(gen, step) -> batch``.

:func:`batch_source` synthesises the model zoo's agent-stacked LM batches
(``src/repro/data/batch_source.py``): token ids, and a VLM's ``patches`` or
an encoder-decoder's ``frames``.

:func:`minibatch_source` draws iid uniform per-agent minibatches from an
agent-sharded dataset held on the device (paper Section 5 line 4: "Draw the
local mini-batch of size b uniformly at random").  The indices come from
the round's generator, on the device, so a chunk never waits on the host.

:func:`dirichlet_partition` builds Dirichlet-heterogeneous per-agent shards
on the host (a numpy copy of ``src/repro/data/batch_source.py``'s: the same
seed gives the same shards), and :func:`dirichlet_source` serves
minibatches from them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.agents import local_rows
from .synthetic import token_batch

__all__ = ["batch_source", "minibatch_source", "dirichlet_partition",
           "dirichlet_source"]


def batch_source(cfg, n_agents: int, batch: int, seq: int, device=None,
                 group=None):
    """The family's synthetic LM batches on ``device`` (cuda unless given),
    the layout ``bundle.loss`` takes with a leading agent axis:

        dense / moe / rwkv6 / hybrid : tokens (n, b, seq) int32
        vlm    : tokens (n, b, seq - n_prefix), patches (n, b, n_prefix, F)
        encdec : frames (n, b, seq, F), tokens (n, b, seq)

    ``patches`` and ``frames`` are N(0, 1) f32.  The draws come from the
    round's generator in the order listed; ``step`` is unused (the stream
    is iid in the generator).  Under an agent ``group`` (``n_agents`` all
    agents) each draw is the one-card one and the batch this rank's row.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    rows = n_agents if group is None else 1

    def tokens(gen, s):
        return token_batch(gen, n_agents, batch, s, cfg.vocab, device, group)

    def normal(gen, s):
        return local_rows(group, (rows, batch, s, cfg.frontend_dim),
                          lambda full: torch.randn(full, generator=gen,
                                                   device=device))

    if cfg.family == "vlm":
        def source(gen, step):
            del step
            ids = tokens(gen, seq - cfg.n_prefix)
            return {"tokens": ids, "patches": normal(gen, cfg.n_prefix)}
    elif cfg.family == "encdec":
        def source(gen, step):
            del step
            frames = normal(gen, seq)
            return {"frames": frames, "tokens": tokens(gen, seq)}
    else:
        def source(gen, step):
            del step
            return {"tokens": tokens(gen, seq)}
    return source


def minibatch_source(xs, ys, batch: int, device=None, group=None):
    """Uniform iid per-agent minibatches from an agent-sharded dataset.

    xs / ys: ``(n_agents, m, ...)`` arrays (e.g. from
    :func:`repro_torch.data.shard_to_agents`), moved to ``device`` (cuda
    unless given) once here.  Each call gathers ``(n_agents, batch, ...)``
    feature and label stacks.  Under an agent ``group`` only this rank's
    shards move to the device (its block of k = n_agents / ranks agents:
    one, or a fleet's), and each call draws every agent's indices (the
    one-card draw) and gathers this rank's ``(k, batch, ...)``.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    if group is not None:
        xs, ys = group.rows(xs), group.rows(ys)
    xs = torch.as_tensor(xs).to(device)
    ys = torch.as_tensor(ys).to(device)
    m = xs.shape[1]
    rows = torch.arange(xs.shape[0], device=device)[:, None]

    def source(gen, step):
        del step  # iid in the generator
        idx = local_rows(group, (xs.shape[0], batch), lambda full:
                         torch.randint(0, m, full, generator=gen,
                                       device=device))
        return xs[rows, idx], ys[rows, idx]

    return source


def dirichlet_partition(xs, ys, n_agents: int, alpha: float = 0.3,
                        shard: int = 0, seed: int = 0):
    """Heterogeneous per-agent shards: class mixture ~ Dirichlet(alpha).

    The federated-learning non-iid protocol [HQB19]: each agent i draws a
    class-mixture vector p_i ~ Dirichlet(alpha * 1) and fills a shard of
    ``shard`` samples (default ``len(xs) // n_agents``) whose class counts
    follow Multinomial(shard, p_i), drawn with replacement from that
    class's pool.  ``alpha -> inf`` recovers iid shards, ``alpha -> 0``
    one class an agent.

    Host numpy, once at set-up; returns ``(n_agents, shard, ...)`` stacks
    for :func:`minibatch_source`.
    """
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if xs.shape[0] != ys.shape[0]:
        raise ValueError(f"xs/ys disagree on dataset size: "
                         f"{xs.shape[0]} vs {ys.shape[0]}")
    if alpha <= 0.0:
        raise ValueError(f"Dirichlet concentration must be > 0, got {alpha}")
    labels = ys.reshape(ys.shape[0], -1)[:, 0]
    # binary +/-1 labels (a9a_like) and 0..K-1 ints both map to classes
    classes, class_ids = np.unique(labels, return_inverse=True)
    pools = [np.nonzero(class_ids == c)[0] for c in range(classes.size)]
    shard = int(shard) if shard else max(xs.shape[0] // n_agents, 1)
    rng = np.random.default_rng(seed)
    mix = rng.dirichlet(np.full(classes.size, alpha), size=n_agents)
    idx = np.empty((n_agents, shard), dtype=np.int64)
    for i in range(n_agents):
        counts = rng.multinomial(shard, mix[i])
        cursor = 0
        for c, cnt in enumerate(counts):
            if cnt:
                idx[i, cursor:cursor + cnt] = rng.choice(pools[c], size=cnt,
                                                         replace=True)
                cursor += cnt
        rng.shuffle(idx[i])
    return xs[idx], ys[idx]


def dirichlet_source(xs, ys, n_agents: int, batch: int, alpha: float = 0.3,
                     shard: int = 0, seed: int = 0, device=None, group=None):
    """:func:`dirichlet_partition` composed with :func:`minibatch_source`
    on ``device`` (cuda unless given): per-agent non-iid shards, minibatches
    drawn on the device (this rank's under an agent ``group``)."""
    sx, sy = dirichlet_partition(xs, ys, n_agents, alpha=alpha, shard=shard,
                                 seed=seed)
    return minibatch_source(sx, sy, batch, device=device, group=group)
