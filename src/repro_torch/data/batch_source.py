"""Batch sources on the device: ``(gen, step) -> batch``.

:func:`minibatch_source` draws iid uniform per-agent minibatches from an
agent-sharded dataset held on the device (paper Section 5 line 4: "Draw the
local mini-batch of size b uniformly at random").  The indices come from
the round's generator, on the device, so a chunk never waits on the host.
"""

from __future__ import annotations

import torch

__all__ = ["minibatch_source"]


def minibatch_source(xs, ys, batch: int, device=None):
    """Uniform iid per-agent minibatches from an agent-sharded dataset.

    xs / ys: ``(n_agents, m, ...)`` arrays (e.g. from
    :func:`repro_torch.data.shard_to_agents`), moved to ``device`` (cuda
    unless given) once here.  Each call gathers ``(n_agents, batch, ...)``
    feature and label stacks.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    xs = torch.as_tensor(xs).to(device)
    ys = torch.as_tensor(ys).to(device)
    n_agents, m = xs.shape[0], xs.shape[1]
    rows = torch.arange(n_agents, device=device)[:, None]

    def source(gen, step):
        del step  # iid in the generator
        idx = torch.randint(0, m, (n_agents, batch), generator=gen,
                            device=device)
        return xs[rows, idx], ys[rows, idx]

    return source
