"""Communication graphs and doubly stochastic mixing matrices (paper
Definition 1), in numpy: a few hundred host-side entries per graph.

The static part of ``src/repro/core/mixing.py``: the graph builders,
``build_adjacency``, the ``metropolis`` / ``best_constant`` / ``lazy``
weight schemes, the mixing rate alpha = || W - 11^T/n ||_op, and
:class:`Topology`.  Time-varying schedules and their generators wait for a
later slice (ROADMAP queue 1 item 3).  Every function is deterministic given
its seed and returns the reference's matrices exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["Topology", "ring_graph", "torus_graph", "erdos_renyi_graph",
           "complete_graph", "star_graph", "exponential_graph",
           "hypercube_graph", "build_adjacency", "mixing_matrix",
           "mixing_rate", "spectral_gap", "make_topology"]

GraphKind = Literal["ring", "torus", "erdos_renyi", "complete", "star",
                    "exponential", "hypercube"]
WeightKind = Literal["metropolis", "best_constant", "lazy"]


def ring_graph(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1.0
    np.fill_diagonal(a, 0.0)
    return a


def torus_graph(n: int) -> np.ndarray:
    """2D torus on the most-square factorization of n."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    c = n // r
    a = np.zeros((n, n), dtype=np.float64)

    def node(i, j):
        return (i % r) * c + (j % c)

    for i in range(r):
        for j in range(c):
            u = node(i, j)
            for v in (node(i + 1, j), node(i, j + 1)):
                if u != v:
                    a[u, v] = a[v, u] = 1.0
    return a


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> np.ndarray:
    """ER(p) graph; re-sample until connected (the paper's setup, p=0.8)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        a = (rng.random((n, n)) < p).astype(np.float64)
        a = np.triu(a, 1)
        a = a + a.T
        if _is_connected(a):
            return a
    raise RuntimeError("could not sample a connected ER graph")


def complete_graph(n: int) -> np.ndarray:
    a = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(a, 0.0)
    return a


def exponential_graph(n: int) -> np.ndarray:
    """One-peer exponential graph: i ~ i +- 2^k (mod n)."""
    a = np.zeros((n, n), dtype=np.float64)
    k = 1
    while k < n:
        for i in range(n):
            a[i, (i + k) % n] = a[(i + k) % n, i] = 1.0
        k *= 2
    np.fill_diagonal(a, 0.0)
    return a


def hypercube_graph(n: int) -> np.ndarray:
    """Hypercube on n = 2^m nodes (i ~ j iff popcount(i^j) == 1)."""
    if n & (n - 1):
        raise ValueError(f"hypercube needs a power-of-two size, got {n}")
    a = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for b in range(n.bit_length() - 1):
            j = i ^ (1 << b)
            a[i, j] = a[j, i] = 1.0
    return a


def star_graph(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.float64)
    a[0, 1:] = a[1:, 0] = 1.0
    return a


def _is_connected(a: np.ndarray) -> bool:
    n = a.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        u = frontier.pop()
        for v in np.nonzero(a[u])[0]:
            if v not in seen:
                seen.add(int(v))
                frontier.append(int(v))
    return len(seen) == n


_BUILDERS = {"ring": ring_graph, "torus": torus_graph,
             "complete": complete_graph, "star": star_graph,
             "exponential": exponential_graph, "hypercube": hypercube_graph}


def build_adjacency(kind: GraphKind, n: int, p: float = 0.8,
                    seed: int = 0) -> np.ndarray:
    if kind == "erdos_renyi":
        return erdos_renyi_graph(n, p, seed)
    if kind not in _BUILDERS:
        raise ValueError(f"unknown graph kind {kind!r}")
    return _BUILDERS[kind](n)


def mixing_matrix(adj: np.ndarray,
                  weights: WeightKind = "metropolis") -> np.ndarray:
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    if weights in ("metropolis", "lazy"):
        w = np.zeros_like(adj)
        for i in range(n):
            for j in np.nonzero(adj[i])[0]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        if weights == "lazy":
            w = 0.5 * (np.eye(n) + w)
        return w
    if weights == "best_constant":
        lap = np.diag(deg) - adj
        lam = np.sort(np.linalg.eigvalsh(lap))  # ascending, lam[0] ~ 0
        eps = 2.0 / (lam[-1] + lam[1])
        return np.eye(n) - eps * lap
    raise ValueError(f"unknown weight kind {weights!r}")


def mixing_rate(w: np.ndarray) -> float:
    """alpha = || W - 11^T/n ||_op (Definition 1)."""
    n = w.shape[0]
    return float(np.linalg.norm(w - np.ones((n, n)) / n, ord=2))


def spectral_gap(w: np.ndarray) -> float:
    """1 - alpha: the gap PORTER's rates are parameterized by."""
    return 1.0 - mixing_rate(w)


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication graph with its mixing matrix and spectral summary."""

    kind: str
    n: int
    adjacency: np.ndarray
    w: np.ndarray
    alpha: float

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.alpha


def make_topology(kind: GraphKind, n: int, weights: WeightKind = "metropolis",
                  p: float = 0.8, seed: int = 0) -> Topology:
    adj = build_adjacency(kind, n, p=p, seed=seed)
    w = mixing_matrix(adj, weights)
    if not (np.allclose(w.sum(0), 1.0, atol=1e-9)
            and np.allclose(w.sum(1), 1.0, atol=1e-9)):
        raise ValueError(f"{kind}/{weights} mixing matrix is not doubly "
                         "stochastic (Definition 1)")
    return Topology(kind=kind, n=n, adjacency=adj, w=w, alpha=mixing_rate(w))
