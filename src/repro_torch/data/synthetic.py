"""Synthetic datasets, numpy copies of ``src/repro/data/synthetic.py``.

Same generators, same seeds, bit-identical arrays:

* ``a9a_like``   -- binary classification, d=123 sparse-ish features, labels
                    in {0, 1} (paper Section 5.1).
* ``mnist_like`` -- 10-class 784-dim images with class-dependent smooth means
                    (paper Section 5.2).
* ``shard_to_agents`` -- shuffle and split evenly across agents.

and :func:`token_batch`, the LM's synthetic token ids, drawn on the device
from a ``torch.Generator`` (the reference draws them with ``jax.random``,
whose streams PyTorch cannot reproduce: the parity tests inject the
reference's draws).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["a9a_like", "mnist_like", "shard_to_agents", "token_batch"]


def a9a_like(num: int = 32561, dim: int = 123, seed: int = 0,
             sparsity: float = 0.11) -> Tuple[np.ndarray, np.ndarray]:
    """Binary classification with a planted linear signal + label noise.

    a9a is ~11% dense binary features; we mimic that so gradient scales (and
    hence clipping behaviour) are comparable.
    """
    rng = np.random.default_rng(seed)
    x = (rng.random((num, dim)) < sparsity).astype(np.float32)
    w_star = rng.normal(size=(dim,)).astype(np.float32)
    logits = x @ w_star / np.sqrt(dim * sparsity)
    p = 1.0 / (1.0 + np.exp(-4.0 * logits))
    y = (rng.random(num) < p).astype(np.float32)
    return x, y


def mnist_like(num: int = 60000, dim: int = 784, classes: int = 10,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """10-class images: class-dependent smooth means + pixel noise in [0,1]."""
    rng = np.random.default_rng(seed)
    # smooth class prototypes: random low-frequency mixtures
    freq = rng.normal(size=(classes, 8, dim)).astype(np.float32)
    coef = rng.normal(size=(classes, 8, 1)).astype(np.float32)
    protos = np.tanh((freq * coef).sum(axis=1) / 4.0) * 0.5 + 0.5
    y = rng.integers(0, classes, size=num)
    x = protos[y] + 0.25 * rng.normal(size=(num, dim)).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return x, y.astype(np.int32)


def shard_to_agents(x: np.ndarray, y: np.ndarray, n_agents: int,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffle and split evenly across agents (paper Section 5 protocol).

    Returns arrays with a leading (n_agents, m) layout; m = num // n_agents.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    m = len(x) // n_agents
    keep = perm[: m * n_agents]
    xs = x[keep].reshape(n_agents, m, *x.shape[1:])
    ys = y[keep].reshape(n_agents, m, *y.shape[1:])
    return xs, ys


def token_batch(gen: torch.Generator, n_agents: int, batch: int, seq: int,
                vocab: int, device=None) -> torch.Tensor:
    """Synthetic LM tokens: ``(n_agents, batch, seq)`` int32 ids uniform in
    ``[0, vocab)``, drawn from ``gen`` on ``device`` (the generator's
    unless given)."""
    device = gen.device if device is None else torch.device(device)
    return torch.randint(0, vocab, (n_agents, batch, seq), generator=gen,
                         dtype=torch.int32, device=device)
