"""Communication graphs and mixing matrices, in numpy: a few hundred
host-side entries per graph.  A copy of ``src/repro/core/mixing.py``.

Undirected graphs carry a doubly stochastic W (paper Definition 1): the
graph builders, ``build_adjacency``, the ``metropolis`` / ``best_constant``
/ ``lazy`` weight schemes, the mixing rate alpha = || W - 11^T/n ||_op, and
:class:`Topology`.  Directed graphs carry a column-stochastic W for
push-sum (dp-csgp): ``A[i, j] = 1 <=> edge j -> i``, and node j splits its
mass equally over its out-neighbours and itself
(:func:`column_stochastic_matrix`).

Time-varying topologies: a :class:`TopologySchedule` stacks a periodic
window ``W_0 .. W_{p-1}``; round t mixes with ``W_{t mod p}``.  Generators
(``SCHEDULE_STOCHASTICITY`` says which stochasticity each gives): doubly
stochastic ``rotate``, ``erdos_renyi``, ``dropout``, ``straggler`` (and
``static`` around a :class:`Topology`); column stochastic ``ring_skips``,
``digraph``, ``one_way``.  Construction validates the window: a
(strongly, when directed) connected union graph and a joint contraction
below 1 -- ``|| (W_{p-1} - J) ... (W_0 - J) ||_op`` for doubly stochastic
windows, the second-largest eigenvalue modulus of ``W_{p-1} ... W_0`` for
directed ones.  Above ``VALIDATE_DENSE_GATE`` agents the validators take
matvecs and edge-list searches instead of dense products.

Every function is deterministic given its seed, and draws from numpy's
``Generator`` in the reference's order, so every matrix and table equals
the reference's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence, Tuple

import numpy as np

try:  # the sparse validators' Lanczos / Arnoldi; power iteration without
    from scipy.sparse.linalg import LinearOperator as _LinOp
    from scipy.sparse.linalg import eigs as _eigs
    from scipy.sparse.linalg import eigsh as _eigsh
except ImportError:  # pragma: no cover - scipy is installed beside torch
    _LinOp = _eigs = _eigsh = None

__all__ = ["Topology", "TopologySchedule", "ring_graph", "torus_graph",
           "erdos_renyi_graph", "complete_graph", "star_graph",
           "exponential_graph", "hypercube_graph", "build_adjacency",
           "mixing_matrix", "mixing_rate", "spectral_gap",
           "contraction_factor", "make_topology", "static_schedule",
           "rotating_schedule", "erdos_renyi_schedule", "dropout_schedule",
           "straggler_schedule", "directed_ring_graph",
           "column_stochastic_matrix", "directed_ring_schedule",
           "random_digraph_schedule", "directed_churn_schedule",
           "make_schedule", "SCHEDULE_STOCHASTICITY", "VALIDATE_DENSE_GATE",
           "mixing_rate_power", "joint_window_alpha",
           "joint_window_contraction", "union_connected"]

# n above which schedule validation takes matvecs and edge-list searches
# instead of dense (n, n) products, SVDs and eigensolves
VALIDATE_DENSE_GATE = 256

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


def contraction_factor(w: np.ndarray) -> float:
    """Second-largest eigenvalue modulus of a (column-)stochastic matrix:
    the eigenvalue nearest 1 (the Perron root) is dropped.  For the
    symmetric doubly stochastic matrices built here it equals
    :func:`mixing_rate`; for a directed W, whose ``|| W - J ||_op`` can
    exceed 1 although W mixes, it is what push-sum contracts by.  A matrix
    whose eigenvalue 1 is not simple (a disconnected round) gives 1.0."""
    ev = np.linalg.eigvals(np.asarray(w, np.float64))
    rest = np.delete(ev, int(np.argmin(np.abs(ev - 1.0))))
    if rest.size == 0:
        return 0.0
    return float(np.max(np.abs(rest)))


def _is_connected_directed(a: np.ndarray) -> bool:
    """Search from node 0, following row u's nonzeros out of node u."""
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


def _is_strongly_connected(a: np.ndarray) -> bool:
    """Strong connectivity of ``A[i, j] = 1 <=> j -> i``: node 0 reaches
    every node (on A^T) and every node reaches node 0 (on A)."""
    return _is_connected_directed(a.T) and _is_connected_directed(a)


# ---------------------------------------------------------------------------
# matvec and edge-list validators for large schedules (n > the gate): the
# same three quantities as the dense ones -- per-round alpha, the window's
# joint alpha or contraction, union connectivity -- without (n, n) products
# ---------------------------------------------------------------------------

def _deflated_window_matvec(ws, x: np.ndarray, transpose: bool) -> np.ndarray:
    """B x (or B^T x) for B = (W_{p-1} - J) ... (W_0 - J), without forming
    B: (W - J) x = W x - mean(x) 1, and J^T = J."""
    order = range(len(ws) - 1, -1, -1) if transpose else range(len(ws))
    for t in order:
        w = ws[t].T if transpose else ws[t]
        x = w @ x - x.mean()
    return x


def joint_window_alpha(ws, method: str = "dense", iters: int = 300,
                       seed: int = 0) -> float:
    """``|| (W_{p-1} - J) ... (W_0 - J) ||_op`` of a doubly stochastic
    window: the product and its SVD (``"dense"``), or Lanczos / power
    iteration on B^T B (``"power"``)."""
    ws = np.stack([np.asarray(w, np.float64) for w in ws])
    n = ws.shape[-1]
    if method == "dense":
        j = np.ones((n, n)) / n
        b = np.eye(n)
        for w in ws:
            b = (w - j) @ b
        return float(np.linalg.norm(b, ord=2))
    if method != "power":
        raise ValueError(f"unknown method {method!r}; have dense, power")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x -= x.mean()
    x /= np.linalg.norm(x) + 1e-300
    if _eigsh is not None and n >= 3:
        op = _LinOp((n, n), matvec=lambda v: _deflated_window_matvec(
            ws, _deflated_window_matvec(ws, v, False), True),
            dtype=np.float64)
        try:
            val = _eigsh(op, k=1, which="LA", v0=x, maxiter=max(50 * n, 2000),
                         tol=1e-12, return_eigenvectors=False)
            return float(np.sqrt(max(float(val[0]), 0.0)))
        except Exception:  # ARPACK did not converge: power iteration
            pass
    est = 0.0
    for _ in range(iters):
        y = _deflated_window_matvec(
            ws, _deflated_window_matvec(ws, x, False), True)
        nrm = float(np.linalg.norm(y))
        if nrm < 1e-300:
            return 0.0
        est = nrm
        x = y / nrm
    return float(np.sqrt(est))


def mixing_rate_power(w: np.ndarray, iters: int = 300, seed: int = 0) -> float:
    """alpha = || W - J ||_op by iteration (the matvec :func:`mixing_rate`)."""
    return joint_window_alpha([w], method="power", iters=iters, seed=seed)


def joint_window_contraction(ws, method: str = "dense", iters: int = 400,
                             seed: int = 0) -> float:
    """Second-largest eigenvalue modulus of ``P = W_{p-1} ... W_0`` for a
    column-stochastic window: :func:`contraction_factor` of the product
    (``"dense"``), or Arnoldi / power iteration on the sum-zero subspace,
    which P keeps and where its spectrum is its non-Perron one
    (``"power"``)."""
    ws = np.stack([np.asarray(w, np.float64) for w in ws])
    n = ws.shape[-1]
    if method == "dense":
        prod = np.eye(n)
        for w in ws:
            prod = w @ prod
        return contraction_factor(prod)
    if method != "power":
        raise ValueError(f"unknown method {method!r}; have dense, power")

    def window_deflated(v):
        for w in ws:
            v = w @ v
        return v - v.mean()

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x -= x.mean()
    nrm = np.linalg.norm(x)
    if nrm < 1e-300:
        return 0.0
    x /= nrm
    if _eigs is not None and n >= 4:
        op = _LinOp((n, n), matvec=window_deflated, dtype=np.float64)
        try:
            val = _eigs(op, k=1, which="LM", v0=x, maxiter=max(50 * n, 2000),
                        tol=1e-12, return_eigenvectors=False)
            return float(np.abs(val[0]))
        except Exception:  # ARPACK did not converge: power iteration
            pass
    logs = []
    for _ in range(iters):
        for w in ws:
            x = w @ x
        x -= x.mean()
        nrm = float(np.linalg.norm(x))
        if nrm < 1e-300:
            return 0.0
        logs.append(np.log(nrm))
        x /= nrm
    tail = logs[len(logs) // 2:]
    return float(np.exp(np.mean(tail)))


def union_connected(adjs, directed: bool = False) -> bool:
    """Connectivity (strong, when directed) of the window's union graph by
    an edge-list search over the stacked ``(period, n, n)`` adjacencies
    (``A[i, j] != 0 <=> edge j -> i``)."""
    adjs = np.stack([np.asarray(a) for a in adjs])
    n = adjs.shape[-1]
    rows, cols = np.nonzero((np.abs(adjs).sum(axis=0) > 0))

    def search(fwd_rows, fwd_cols) -> bool:
        adj = [[] for _ in range(n)]
        for u, v in zip(fwd_rows.tolist(), fwd_cols.tolist()):
            adj[u].append(v)
        seen = np.zeros(n, dtype=bool)
        seen[0] = True
        frontier = [0]
        while frontier:
            u = frontier.pop()
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    frontier.append(v)
        return bool(seen.all())

    if not directed:
        return search(np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    return search(cols, rows) and search(rows, cols)


def _w_is_banded_ring(w: np.ndarray) -> bool:
    """True when ``w`` couples each node only to itself and its two ring
    neighbours."""
    off = w.copy()
    np.fill_diagonal(off, 0.0)
    allowed = ring_graph(w.shape[0]) > 0
    return bool(np.all((np.abs(off) < 1e-12) | allowed))


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

    def is_banded_ring(self) -> bool:
        """True when W only couples ring neighbours (the ring executor's
        shifts then carry the whole mix)."""
        return _w_is_banded_ring(self.w)


def make_topology(kind: GraphKind, n: int, weights: WeightKind = "metropolis",
                  p: float = 0.8, seed: int = 0) -> Topology:
    adj = build_adjacency(kind, n, p=p, seed=seed)
    w = mixing_matrix(adj, weights)
    if not (np.allclose(w.sum(0), 1.0, atol=1e-9)
            and np.allclose(w.sum(1), 1.0, atol=1e-9)):
        raise ValueError(f"{kind}/{weights} mixing matrix is not doubly "
                         "stochastic (Definition 1)")
    return Topology(kind=kind, n=n, adjacency=adj, w=w, alpha=mixing_rate(w))


# ---------------------------------------------------------------------------
# time-varying topologies: periodic schedules of mixing matrices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A periodic window of mixing matrices; round t mixes with
    ``W_{t mod period}``.

    ``ws`` is the stacked ``(period, n, n)`` f64 table (the gossip
    executors keep an f32 copy of it on the device and index it with the
    round).  ``stochasticity`` is ``"doubly"`` (undirected) or
    ``"column"`` (directed, push-sum).  ``alphas`` are the per-round rates
    (1 for a round whose graph is disconnected); ``joint_alpha`` is the
    window's contraction (see the module docstring), below 1 by
    construction.
    """

    kind: str
    n: int
    ws: np.ndarray            # (period, n, n)
    adjacencies: np.ndarray   # (period, n, n), binary
    alphas: Tuple[float, ...]
    joint_alpha: float
    stochasticity: str = "doubly"

    @property
    def period(self) -> int:
        return self.ws.shape[0]

    @property
    def is_directed(self) -> bool:
        """True for column-stochastic (push-sum) schedules."""
        return self.stochasticity == "column"

    @property
    def alpha(self) -> float:
        """Per-round geometric rate ``joint_alpha ** (1 / period)``: the
        schedule's alpha in ``gamma = scale * (1 - alpha) * rho``; a
        period-1 schedule gives its round's alpha exactly."""
        if self.period == 1:
            return self.alphas[0]
        return float(self.joint_alpha ** (1.0 / self.period))

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.alpha

    @property
    def joint_spectral_gap(self) -> float:
        return 1.0 - self.joint_alpha

    def window_union(self) -> np.ndarray:
        """Binary adjacency of the union graph over one period."""
        return (self.adjacencies.sum(axis=0) > 0).astype(np.float64)

    def is_banded_ring(self) -> bool:
        """True when every round's W only couples ring neighbours (the ring
        executor then keeps its shifts and picks the band weights by the
        round)."""
        return all(_w_is_banded_ring(w) for w in self.ws)

    def at(self, t: int) -> np.ndarray:
        """W_t (numpy) for round ``t``."""
        return self.ws[int(t) % self.period]


def _stack_window(n: int, ws, adjs):
    ws = np.stack([np.asarray(w, np.float64) for w in ws])
    adjs = np.stack([np.asarray(a, np.float64) for a in adjs])
    if ws.ndim != 3 or ws.shape[1] != n or ws.shape[2] != n:
        raise ValueError(f"schedule table must be (period, {n}, {n}); got "
                         f"{ws.shape}")
    return ws, adjs


def _finalize_schedule(kind: str, n: int, ws, adjs) -> TopologySchedule:
    """Validate a doubly stochastic window and compute its spectral
    summary."""
    ws, adjs = _stack_window(n, ws, adjs)
    for t, w in enumerate(ws):
        if not (np.allclose(w.sum(0), 1.0, atol=1e-9)
                and np.allclose(w.sum(1), 1.0, atol=1e-9)):
            raise ValueError(f"schedule round {t} is not doubly stochastic "
                             "(Definition 1)")
    sparse = n > VALIDATE_DENSE_GATE
    if sparse:
        connected = union_connected(adjs, directed=False)
    else:
        connected = _is_connected((adjs.sum(axis=0) > 0).astype(np.float64))
    if not connected:
        raise ValueError(
            f"{kind!r} schedule: the union graph over the {ws.shape[0]}-round "
            "window is disconnected -- some agent never talks to the rest, "
            "so no amount of rounds reaches consensus.  Lower the churn "
            "rate, lengthen the period, or densify the base graph.")
    joint = joint_window_alpha(ws, method="power" if sparse else "dense")
    if joint >= 1.0 - (1e-9 if sparse else 1e-12):
        raise ValueError(
            f"{kind!r} schedule does not mix over its window "
            f"(joint alpha = {joint:.6f} >= 1); the paper's consensus "
            "stepsize would degenerate to 0")
    rate = mixing_rate_power if sparse else mixing_rate
    return TopologySchedule(kind=kind, n=n, ws=ws, adjacencies=adjs,
                            alphas=tuple(rate(w) for w in ws),
                            joint_alpha=joint)


def static_schedule(topology: Topology) -> TopologySchedule:
    """Period-1 schedule around a static topology; its alpha is the
    topology's own."""
    sched = _finalize_schedule(f"static:{topology.kind}", topology.n,
                               [topology.w], [topology.adjacency])
    return dataclasses.replace(sched, alphas=(topology.alpha,))


def rotating_schedule(kinds: Sequence[str], n: int,
                      weights: WeightKind = "metropolis", p: float = 0.8,
                      seed: int = 0) -> TopologySchedule:
    """One graph kind a round, in turn; an entry ``kind/weights`` (e.g.
    ``ring/lazy``) takes its own weight scheme."""
    if not kinds:
        raise ValueError("rotating schedule needs at least one graph kind")
    ws, adjs = [], []
    for entry in kinds:
        kind, _, wk = str(entry).partition("/")
        adj = build_adjacency(kind, n, p=p, seed=seed)
        ws.append(mixing_matrix(adj, wk or weights))
        adjs.append(adj)
    return _finalize_schedule(f"rotate:{'+'.join(map(str, kinds))}", n, ws,
                              adjs)


def erdos_renyi_schedule(n: int, p: float = 0.8, period: int = 8,
                         weights: WeightKind = "metropolis",
                         seed: int = 0) -> TopologySchedule:
    """A fresh connected ER(p) graph every round."""
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    ws, adjs = [], []
    for t in range(period):
        adj = erdos_renyi_graph(n, p, seed=seed * 10007 + t)
        ws.append(mixing_matrix(adj, weights))
        adjs.append(adj)
    return _finalize_schedule(f"erdos_renyi:p={p}", n, ws, adjs)


def _churn_weights(weights: WeightKind) -> WeightKind:
    if weights == "best_constant":
        raise ValueError(
            "churn schedules cannot use best_constant weights: a round with "
            "dropped agents/links has a disconnected Laplacian (lambda_2 = "
            "0), so the closed form divides by zero -- use metropolis or "
            "lazy")
    return weights


def _pruned_rounds(kind: str, n: int, base_adj: np.ndarray, period: int,
                   weights: WeightKind, seed: int, prune_one):
    """Draw windows of pruned copies of ``base_adj`` until the union is
    connected; ``prune_one(rng, adj) -> adj_t`` drops agents or links."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        adjs = [prune_one(rng, base_adj) for _ in range(period)]
        if _is_connected((np.sum(adjs, axis=0) > 0).astype(np.float64)):
            ws = [mixing_matrix(a, weights) for a in adjs]
            return _finalize_schedule(kind, n, ws, adjs)
    raise RuntimeError(
        f"could not sample a window-connected {kind!r} schedule in 1000 "
        "tries; the churn rate is too high for this period/base graph")


def dropout_schedule(n: int, rate: float = 0.2, period: int = 8,
                     base: GraphKind = "ring",
                     weights: WeightKind = "metropolis", p: float = 0.8,
                     seed: int = 0) -> TopologySchedule:
    """Agent churn: every round each agent is offline with probability
    ``rate`` (its row of W is e_i); the rest re-derive their weights on the
    pruned graph, so every round stays doubly stochastic."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    base_adj = build_adjacency(base, n, p=p, seed=seed)

    def prune(rng, adj):
        active = rng.random(n) >= rate
        return adj * active[:, None] * active[None, :]

    return _pruned_rounds(f"dropout:rate={rate},base={base}", n, base_adj,
                          period, _churn_weights(weights), seed, prune)


def straggler_schedule(n: int, rate: float = 0.2, period: int = 8,
                       base: GraphKind = "ring",
                       weights: WeightKind = "metropolis", p: float = 0.8,
                       seed: int = 0) -> TopologySchedule:
    """Stragglers: every round each link of the base graph misses the
    deadline with probability ``rate``, both ways at once, so W_t stays
    doubly stochastic."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"straggler rate must be in [0, 1), got {rate}")
    base_adj = build_adjacency(base, n, p=p, seed=seed)

    def prune(rng, adj):
        keep = np.triu(rng.random((n, n)) >= rate, 1)
        return adj * (keep + keep.T)

    return _pruned_rounds(f"straggler:rate={rate},base={base}", n, base_adj,
                          period, _churn_weights(weights), seed, prune)


# ---------------------------------------------------------------------------
# directed (column-stochastic) schedules for push-sum
# ---------------------------------------------------------------------------

def directed_ring_graph(n: int, skip: int = 0) -> np.ndarray:
    """``A[i, j] = 1 <=> j -> i``: every node sends to j + 1, and to
    j + skip as well when ``skip >= 2``."""
    if n < 2:
        raise ValueError(f"directed ring needs n >= 2, got {n}")
    if skip and not 2 <= skip < n:
        raise ValueError(f"skip must be 0 or in [2, n), got {skip}")
    a = np.zeros((n, n), dtype=np.float64)
    for j in range(n):
        a[(j + 1) % n, j] = 1.0
        if skip:
            a[(j + skip) % n, j] = 1.0
    np.fill_diagonal(a, 0.0)
    return a


def column_stochastic_matrix(adj: np.ndarray) -> np.ndarray:
    """``w_ij = 1 / (outdeg_j + 1)`` on every edge j -> i and on the
    diagonal: columns sum to 1 and every diagonal entry is positive, which
    keeps the push-sum weights positive."""
    n = adj.shape[0]
    a = (np.asarray(adj, np.float64) > 0).astype(np.float64)
    np.fill_diagonal(a, 0.0)
    out = a.sum(axis=0) + 1.0
    return (a + np.eye(n)) / out[None, :]


def _finalize_directed_schedule(kind: str, n: int, ws, adjs
                                ) -> TopologySchedule:
    """Validate a column-stochastic window: positive diagonals, a strongly
    connected union digraph, a joint contraction below 1."""
    ws, adjs = _stack_window(n, ws, adjs)
    for t, w in enumerate(ws):
        if not np.allclose(w.sum(0), 1.0, atol=1e-9):
            raise ValueError(f"directed schedule round {t} is not column "
                             "stochastic (1^T W != 1^T)")
        if np.any(w < -1e-12):
            raise ValueError(f"directed schedule round {t} has negative "
                             "entries; push-sum weights must stay positive")
        if np.any(np.diag(w) <= 0.0):
            raise ValueError(f"directed schedule round {t} is missing a "
                             "self-loop; push-sum weights could hit zero")
    sparse = n > VALIDATE_DENSE_GATE
    if sparse:
        connected = union_connected(adjs, directed=True)
    else:
        connected = _is_strongly_connected(
            (adjs.sum(axis=0) > 0).astype(np.float64))
    if not connected:
        raise ValueError(
            f"{kind!r} schedule: the union digraph over the "
            f"{ws.shape[0]}-round window is not strongly connected -- some "
            "agent's mass never reaches (or never hears from) the rest, so "
            "push-sum cannot reach consensus.  Lower the loss rate, "
            "lengthen the period, or densify the base digraph.")
    joint = joint_window_contraction(
        ws, method="power" if sparse else "dense")
    if joint >= 1.0 - (1e-9 if sparse else 1e-12):
        raise ValueError(
            f"{kind!r} schedule does not contract over its window "
            f"(joint contraction factor = {joint:.6f} >= 1); the consensus "
            "stepsize would degenerate to 0")
    per_round = ((lambda w: joint_window_contraction([w], method="power"))
                 if sparse else contraction_factor)
    return TopologySchedule(kind=kind, n=n, ws=ws, adjacencies=adjs,
                            alphas=tuple(per_round(w) for w in ws),
                            joint_alpha=joint, stochasticity="column")


def directed_ring_schedule(n: int, skip: int = 0) -> TopologySchedule:
    """Period-1 directed ring, with skip chords when ``skip >= 2``."""
    adj = directed_ring_graph(n, skip=skip)
    return _finalize_directed_schedule(f"ring_skips:skip={skip}", n,
                                       [column_stochastic_matrix(adj)], [adj])


def _directed_window(kind: str, n: int, period: int, sample_adj
                     ) -> TopologySchedule:
    """Draw ``period`` directed adjacencies until the window validates."""
    last_err = None
    for _ in range(1000):
        adjs = [sample_adj() for _ in range(period)]
        ws = [column_stochastic_matrix(a) for a in adjs]
        try:
            return _finalize_directed_schedule(kind, n, ws, adjs)
        except ValueError as e:
            last_err = e
    raise RuntimeError(
        f"could not sample a window-connected {kind!r} schedule in 1000 "
        f"tries; the loss rate is too high for this period/base digraph "
        f"(last: {last_err})")


def random_digraph_schedule(n: int, p: float = 0.5, period: int = 8,
                            seed: int = 0) -> TopologySchedule:
    """Every directed edge j -> i (i != j) present with probability ``p``,
    drawn anew each round; self-loops always."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"digraph edge probability must be in (0, 1], got {p}")
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    rng = np.random.default_rng(seed)
    return _directed_window(f"digraph:p={p}", n, period, lambda: (
        (rng.random((n, n)) < p).astype(np.float64) * (1.0 - np.eye(n))))


def directed_churn_schedule(n: int, rate: float = 0.2, period: int = 8,
                            skip: int = 2, seed: int = 0) -> TopologySchedule:
    """One-way link loss: every round each edge of the directed ring with
    skip chords drops with probability ``rate``, one way at a time."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"one-way loss rate must be in [0, 1), got {rate}")
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    base = directed_ring_graph(n, skip=skip)
    rng = np.random.default_rng(seed)
    return _directed_window(f"one_way:rate={rate},skip={skip}", n, period,
                            lambda: base * (rng.random((n, n)) >= rate))


_SCHEDULE_GENERATORS = {
    "rotate": rotating_schedule,
    "erdos_renyi": erdos_renyi_schedule,
    "dropout": dropout_schedule,
    "straggler": straggler_schedule,
    "ring_skips": directed_ring_schedule,
    "digraph": random_digraph_schedule,
    "one_way": directed_churn_schedule,
}

SCHEDULE_STOCHASTICITY = {
    "rotate": "doubly",
    "erdos_renyi": "doubly",
    "dropout": "doubly",
    "straggler": "doubly",
    "ring_skips": "column",
    "digraph": "column",
    "one_way": "column",
}


def make_schedule(kind: str, n: int, **kwargs) -> TopologySchedule:
    """Generator dispatch: ``kind='static'`` takes ``topology=`` (a built
    :class:`Topology`), the others their own keyword knobs."""
    if kind == "static":
        top = kwargs.pop("topology", None)
        if top is None or kwargs:
            raise ValueError("static schedule needs exactly topology=<Topology>")
        return static_schedule(top)
    if kind not in _SCHEDULE_GENERATORS:
        raise ValueError(f"unknown schedule kind {kind!r}; have "
                         f"{['static'] + sorted(_SCHEDULE_GENERATORS)}")
    return _SCHEDULE_GENERATORS[kind](n=n, **kwargs)
