"""Fleet-scale agents: n >> devices, one leading agent axis on one card
(or sharded over processes).

A copy of ``src/repro/core/fleet.py``.  The agent-stacked state keeps its
layout, with the agent axis grown to n = 1k-100k simulated agents: every
registered ``step`` vectorizes its per-agent gradients over the fleet, and
only the mixing, the one O(n^2) ingredient, changes executor.

Two regimes, one mixer (:func:`make_fleet_mixer`):

* ``n <= FLEET_DENSE_GATE``: the fleet mixer is the port's dense mixer
  (:func:`repro_torch.core.gossip.make_dense_mixer`) on the same f32
  table, so a fleet run is bitwise the per-device engine's.
* ``n > FLEET_DENSE_GATE``: mixing is a sparse product over the COO
  triplets of the sparse generators below (banded ring, exponential 2^k
  chords, degree-sampled Erdos-Renyi), and the ``(n, n)`` table is never
  made.  The reference scatter-adds the triplets (``zeros.at[rows].add(
  vals * x[cols])``), which XLA's CPU backend does one triplet after the
  other in COO order.  Here the triplets are laid out once, when the mixer
  is built, as slots per row (a row's triplets in COO order; the rows
  ordered by slot count), and each apply gathers and multiplies all the
  triplets at once, then adds slot after slot onto zeros in f32: each
  row's terms in the reference's order, and no atomics, so an apply gives the same bits on every run and on
  every device.  A schedule's padding triplets (``_pad_rounds``: zero
  values on row 0, past each round's real nnz) are dropped from the
  layout: they would only add +-0.0 last to row 0.

Across processes (``make_fleet_mixer(obj, group=)``): the fleet axis is
sharded over the P ranks of an agent group, k = n / P agents a rank (the
reference's fleet under pjit).  A mix all-gathers every rank's block and
keeps the rank's rows of the one-card product (the dense one below the
gate, the slots of the rank's own rows above it), so every row is
bitwise the one-card fleet's.

The numpy part (COO tables, spectra, generators) is the reference's own
code: the same arguments give ``np.array_equal`` triplets and the same
floats.  :class:`FleetSchedule` also records each round's real nnz
(``round_nnz``), which the reference's does not keep.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

try:  # scipy is on the card's machine too; the numpy fallback stays
    from scipy.sparse.linalg import LinearOperator as _LinOp
    from scipy.sparse.linalg import eigsh as _eigsh
except Exception:  # pragma: no cover - exercised only without scipy
    _LinOp = _eigsh = None

from ..tree import tree_flatten
from .gossip import (GossipBudget, _check_block, _nbytes, gather_blocks,
                     make_dense_mixer, make_dense_process_mixer)
from .mixing import Topology, TopologySchedule, WeightKind

__all__ = [
    "FLEET_DENSE_GATE",
    "FleetTopology",
    "FleetSchedule",
    "fleet_topology",
    "fleet_rotating_schedule",
    "fleet_er_schedule",
    "make_fleet_mixer",
    "coo_matvec",
    "coo_alpha",
]

# n at or below which the fleet mixer densifies and takes the dense
# mixer (bit parity with the per-device engine); above it, the COO slots.
FLEET_DENSE_GATE = 256

# ---------------------------------------------------------------------------
# COO mixing tables
# ---------------------------------------------------------------------------

def _check_coo(n: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray) -> None:
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise ValueError(f"COO triplets must be flat and aligned; got "
                         f"{rows.shape}/{cols.shape}/{vals.shape}")
    if rows.size and (rows.min() < 0 or rows.max() >= n
                      or cols.min() < 0 or cols.max() >= n):
        raise ValueError(f"COO indices out of range for n={n}")


def coo_matvec(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               x: np.ndarray) -> np.ndarray:
    """Host-side W @ x for one COO table (validation / power iteration)."""
    return np.bincount(rows, weights=vals * x[cols], minlength=n)


def coo_alpha(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              iters: int = 200, seed: int = 0) -> float:
    """``||W - J||_op`` by power iteration on the mean-deflated operator.

    For the symmetric doubly-stochastic W built here, B = W - J is
    symmetric, so plain power iteration on ``B x = W x - mean(x) 1``
    converges to the dominant |eigenvalue| = alpha (Definition 1).
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x -= x.mean()
    x /= np.linalg.norm(x) + 1e-300

    def deflated(v):
        y = coo_matvec(n, rows, cols, vals, v)
        return y - y.mean()    # deflate the Perron direction exactly

    if _eigsh is not None and n >= 3:
        # Lanczos resolves the clustered near-1 ring spectra that plain
        # power iteration needs O(n^2) iterations for
        op = _LinOp((n, n), matvec=deflated, dtype=np.float64)
        try:
            val = _eigsh(op, k=1, which="LM", v0=x, maxiter=max(50 * n, 2000),
                         tol=1e-12, return_eigenvectors=False)
            return float(np.abs(val[0]))
        except Exception:
            pass  # ARPACK no-convergence: fall through to power iteration
    est = 0.0
    for _ in range(iters):
        y = deflated(x)
        nrm = np.linalg.norm(y)
        if nrm < 1e-300:
            return 0.0
        est = nrm
        x = y / nrm
    return float(est)


def _coo_joint_alpha(n: int, rows: np.ndarray, cols: np.ndarray,
                     vals: np.ndarray, iters: int = 120,
                     seed: int = 0) -> float:
    """``|| (W_{p-1}-J) ... (W_0-J) ||_op`` for stacked (period, nnz)
    triplets, via power iteration on B^T B (B = the window product).

    Each round's B_t is symmetric here, so B^T is the product applied in
    reverse round order; B^T B is PSD and power iteration converges to
    sigma_max^2 regardless of B's own symmetry.
    """
    period = rows.shape[0]

    def apply_b(x, order):
        for t in order:
            x = coo_matvec(n, rows[t], cols[t], vals[t], x)
            x -= x.mean()
        return x

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x -= x.mean()
    x /= np.linalg.norm(x) + 1e-300

    def btb(v):
        return apply_b(apply_b(v, range(period)), range(period - 1, -1, -1))

    if _eigsh is not None and n >= 3:
        op = _LinOp((n, n), matvec=btb, dtype=np.float64)
        try:
            val = _eigsh(op, k=1, which="LA", v0=x, maxiter=max(50 * n, 2000),
                         tol=1e-12, return_eigenvectors=False)
            return float(np.sqrt(max(float(val[0]), 0.0)))
        except Exception:
            pass  # ARPACK no-convergence: fall through to power iteration
    est = 0.0
    for _ in range(iters):
        y = btb(x)
        nrm = np.linalg.norm(y)
        if nrm < 1e-300:
            return 0.0
        est = nrm              # -> sigma_max^2
        x = y / nrm
    return float(np.sqrt(est))


def _coo_connected(n: int, rows: np.ndarray, cols: np.ndarray) -> bool:
    """BFS connectivity over the (undirected view of the) COO edge set --
    never materializes an (n, n) table."""
    adj = [[] for _ in range(n)]
    for r, c in zip(rows.reshape(-1).tolist(), cols.reshape(-1).tolist()):
        if r != c:
            adj[r].append(c)
            adj[c].append(r)
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


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """A sparse (COO) mixing matrix for fleet-scale n.

    ``rows/cols/vals`` include the diagonal, so ``W x`` is one sparse product.
    ``alpha`` is the power-iteration estimate of ``||W - J||_op``.
    """

    kind: str
    n: int
    rows: np.ndarray      # (nnz,) int32
    cols: np.ndarray      # (nnz,) int32
    vals: np.ndarray      # (nnz,) float64
    alpha: float

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.alpha

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    def densify(self) -> np.ndarray:
        """Dense (n, n) W -- for tests and small-n parity only."""
        w = np.zeros((self.n, self.n), dtype=np.float64)
        np.add.at(w, (self.rows, self.cols), self.vals)
        return w


@dataclasses.dataclass(frozen=True)
class FleetSchedule:
    """A periodic window of COO mixing tables (doubly stochastic only).

    Triplets are stacked ``(period, nnz)`` with a shared nnz (rounds pad
    with zero-valued ``(0, 0)`` entries), as the reference stacks them.
    ``round_nnz`` is each round's real nnz: the positions past it are
    padding.
    """

    kind: str
    n: int
    rows: np.ndarray      # (period, nnz) int32
    cols: np.ndarray      # (period, nnz) int32
    vals: np.ndarray      # (period, nnz) float64
    alphas: Tuple[float, ...]
    joint_alpha: float
    round_nnz: Tuple[int, ...]

    @property
    def period(self) -> int:
        return int(self.rows.shape[0])

    @property
    def is_directed(self) -> bool:
        return False      # fleet schedules are doubly stochastic

    @property
    def alpha(self) -> float:
        """Per-round geometric mixing rate (mirrors TopologySchedule)."""
        if self.period == 1:
            return self.alphas[0]
        return float(self.joint_alpha ** (1.0 / self.period))

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.alpha

    def densify(self, t: int) -> np.ndarray:
        w = np.zeros((self.n, self.n), dtype=np.float64)
        np.add.at(w, (self.rows[t], self.cols[t]), self.vals[t])
        return w


# ---------------------------------------------------------------------------
# Sparse generators: banded ring / exponential chords / degree-sampled ER
# ---------------------------------------------------------------------------

def _metropolis_coo(n: int, nbr_rows: np.ndarray, nbr_cols: np.ndarray,
                    lazy: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Metropolis weights from an undirected edge list (both directions
    present in nbr_rows/cols, no self loops): w_ij = 1/(1 + max(d_i, d_j)),
    diagonal = 1 - row sum.  Matches mixing.mixing_matrix exactly."""
    deg = np.bincount(nbr_rows, minlength=n).astype(np.float64)
    w_off = 1.0 / (1.0 + np.maximum(deg[nbr_rows], deg[nbr_cols]))
    diag = 1.0 - np.bincount(nbr_rows, weights=w_off, minlength=n)
    if lazy:
        w_off = 0.5 * w_off
        diag = 0.5 * (1.0 + diag)
    rows = np.concatenate([nbr_rows, np.arange(n)]).astype(np.int32)
    cols = np.concatenate([nbr_cols, np.arange(n)]).astype(np.int32)
    vals = np.concatenate([w_off, diag])
    return rows, cols, vals


def _symmetrize(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges (i < j, no self loops) -> both directions."""
    i, j = pairs[:, 0], pairs[:, 1]
    keep = i != j
    i, j = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    uniq = np.unique(np.stack([i, j], axis=1), axis=0)
    rows = np.concatenate([uniq[:, 0], uniq[:, 1]])
    cols = np.concatenate([uniq[:, 1], uniq[:, 0]])
    return rows, cols


def _fleet_edges(kind: str, n: int, p: float, seed: int,
                 degree: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse undirected edge list (both directions) for one round."""
    idx = np.arange(n)
    if kind == "ring":
        if n < 3:
            raise ValueError(f"fleet ring needs n >= 3, got {n}")
        rows = np.concatenate([idx, idx])
        cols = np.concatenate([(idx + 1) % n, (idx - 1) % n])
        return rows, cols
    if kind == "exponential":
        # chords at hop distances 2^k (k = 0 .. floor(log2(n-1))): the
        # standard O(log n)-degree expander used for large-n gossip
        hops = [1 << k for k in range(int(np.log2(max(n - 1, 1))) + 1)
                if (1 << k) <= n // 2]
        pairs = np.concatenate(
            [np.stack([idx, (idx + h) % n], axis=1) for h in hops])
        return _symmetrize(pairs)
    if kind == "erdos_renyi":
        # degree-sampled ER: draw ~ n*deg/2 random pairs instead of
        # flipping n^2/2 coins -- the only ER construction that scales to
        # n = 100k.  ``degree`` defaults to a connectivity-safe
        # 2 * ceil(log2 n); a ring backbone guarantees connectivity
        # without a 1000-attempt resample loop at fleet scale.
        deg = int(degree) if degree is not None else 2 * max(
            int(np.ceil(np.log2(max(n, 2)))), 2)
        rng = np.random.default_rng(seed)
        m = max((n * deg) // 2, 1)
        pairs = rng.integers(0, n, size=(m, 2))
        backbone = np.stack([idx, (idx + 1) % n], axis=1)
        return _symmetrize(np.concatenate([pairs, backbone]))
    raise ValueError(f"unknown fleet topology kind {kind!r}; have "
                     "ring, exponential, erdos_renyi")


def fleet_topology(kind: str, n: int, weights: WeightKind = "metropolis",
                   p: float = 0.8, seed: int = 0,
                   degree: Optional[int] = None,
                   alpha_iters: int = 200) -> FleetTopology:
    """Sparse static topology for fleet-scale n (never builds (n, n)).

    Supported kinds: ``ring`` (banded), ``exponential`` (2^k chords),
    ``erdos_renyi`` (degree-sampled, ring backbone).  Weights: metropolis
    or lazy (best_constant needs a dense eigensolve by definition).
    """
    if weights not in ("metropolis", "lazy"):
        raise ValueError(
            f"fleet topologies support metropolis/lazy weights, got "
            f"{weights!r}: best_constant needs the dense Laplacian "
            "eigensolve the sparse path exists to avoid")
    nbr_rows, nbr_cols = _fleet_edges(kind, n, p, seed, degree)
    rows, cols, vals = _metropolis_coo(n, nbr_rows, nbr_cols,
                                       lazy=(weights == "lazy"))
    _check_coo(n, rows, cols, vals)
    if not _coo_connected(n, nbr_rows, nbr_cols):
        raise ValueError(f"fleet topology {kind!r} (n={n}) is disconnected")
    alpha = coo_alpha(n, rows, cols, vals, iters=alpha_iters, seed=seed)
    return FleetTopology(kind=f"fleet:{kind}", n=n, rows=rows, cols=cols,
                         vals=vals, alpha=alpha)


def _pad_rounds(tables: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-round COO triplets, padding to a common nnz with
    zero-valued (0, 0) entries (the fleet mixer's layout drops them)."""
    nnz = max(r.size for r, _, _ in tables)
    rows = np.zeros((len(tables), nnz), dtype=np.int32)
    cols = np.zeros((len(tables), nnz), dtype=np.int32)
    vals = np.zeros((len(tables), nnz), dtype=np.float64)
    for t, (r, c, v) in enumerate(tables):
        rows[t, :r.size], cols[t, :c.size], vals[t, :v.size] = r, c, v
    return rows, cols, vals


def _finalize_fleet_schedule(kind: str, n: int, tables,
                             alpha_iters: int = 200) -> FleetSchedule:
    rows, cols, vals = _pad_rounds(tables)
    for t in range(rows.shape[0]):
        _check_coo(n, rows[t], cols[t], vals[t])
        rsum = np.bincount(rows[t], weights=vals[t], minlength=n)
        csum = np.bincount(cols[t], weights=vals[t], minlength=n)
        if not (np.allclose(rsum, 1.0, atol=1e-9)
                and np.allclose(csum, 1.0, atol=1e-9)):
            raise ValueError(f"fleet schedule round {t} is not doubly "
                             "stochastic (Definition 1)")
    union_r = rows.reshape(-1)
    union_c = cols.reshape(-1)
    live = np.abs(vals.reshape(-1)) > 0
    if not _coo_connected(n, union_r[live], union_c[live]):
        raise ValueError(f"{kind!r} fleet schedule: window union graph is "
                         "disconnected")
    alphas = tuple(coo_alpha(n, rows[t], cols[t], vals[t],
                             iters=alpha_iters, seed=t)
                   for t in range(rows.shape[0]))
    joint = (alphas[0] if rows.shape[0] == 1
             else _coo_joint_alpha(n, rows, cols, vals))
    if joint >= 1.0 - 1e-9:
        raise ValueError(f"{kind!r} fleet schedule does not mix over its "
                         f"window (joint alpha = {joint:.6f})")
    return FleetSchedule(kind=kind, n=n, rows=rows, cols=cols, vals=vals,
                         alphas=alphas, joint_alpha=joint,
                         round_nnz=tuple(int(r.size) for r, _, _ in tables))


def fleet_rotating_schedule(kinds: Sequence[str], n: int,
                            weights: WeightKind = "metropolis",
                            seed: int = 0) -> FleetSchedule:
    """Rotate through sparse graph kinds (``kind`` or ``kind/weights``),
    one per round -- the fleet analogue of mixing.rotating_schedule."""
    if not kinds:
        raise ValueError("fleet rotating schedule needs >= 1 graph kind")
    tables = []
    for entry in kinds:
        kind, _, wk = str(entry).partition("/")
        top = fleet_topology(kind, n, weights=wk or weights, seed=seed)
        tables.append((top.rows, top.cols, top.vals))
    return _finalize_fleet_schedule(
        f"fleet-rotate:{'+'.join(map(str, kinds))}", n, tables)


def fleet_er_schedule(n: int, period: int = 4, degree: Optional[int] = None,
                      weights: WeightKind = "metropolis",
                      seed: int = 0) -> FleetSchedule:
    """Fresh degree-sampled ER graph every round (per-round resampling)."""
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    tables = []
    for t in range(period):
        top = fleet_topology("erdos_renyi", n, weights=weights,
                             seed=seed * 10007 + t, degree=degree)
        tables.append((top.rows, top.cols, top.vals))
    return _finalize_fleet_schedule(f"fleet-erdos_renyi:period={period}", n,
                                    tables)


# ---------------------------------------------------------------------------
# The fleet mixer
# ---------------------------------------------------------------------------

# one round's layout, on the host: (rank, ks, cols, vals) with rank[i] the
# position of row i in the slot order (None when it is the identity), ks[s]
# the number of rows with an s-th triplet (those rows first in the slot
# order), and cols / vals the triplets slot after slot: slot s's k_s
# triplets start at sum(ks[:s])
_Layout = Tuple[Optional[np.ndarray], Tuple[int, ...], np.ndarray,
                np.ndarray]


def _coo_slots(n: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, block: Optional[Tuple[int, int]] = None
               ) -> _Layout:
    """Lay one round's COO triplets out as slots per row, for the apply.

    A row's triplets keep their COO order (a stable sort by row), so slot
    ``s`` of row ``i`` is the ``s``-th triplet the reference adds into row
    ``i``.  The rows are ordered by slot count, most first (stable), so
    the rows with an ``s``-th slot are a prefix of that order and each
    slot is one contiguous update.  ``vals`` become f32, as the reference
    casts them.  ``block = (lo, k)``: only rows ``[lo, lo + k)``, numbered
    from 0, their columns still global (a rank's rows of the fleet).
    """
    rows = np.asarray(rows, np.int64)
    _check_coo(n, rows, np.asarray(cols), np.asarray(vals))
    if block is not None:
        lo, n = block
        keep = (rows >= lo) & (rows < lo + n)
        rows, cols, vals = (rows[keep] - lo, np.asarray(cols)[keep],
                            np.asarray(vals)[keep])
    by_row = np.argsort(rows, kind="stable")
    r = rows[by_row]
    deg = np.bincount(r, minlength=n)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(r.size) - start[r]
    order = np.argsort(-deg, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    # slot-major, and within a slot the rows in slot order
    idx = np.lexsort((rank[r], slot))
    c = np.asarray(cols, np.int64)[by_row][idx]
    v = np.asarray(vals, np.float64)[by_row][idx].astype(np.float32)
    ks = tuple(int(k) for k in np.bincount(slot, minlength=0))
    identity = bool((order == np.arange(n)).all())
    return (None if identity else rank), ks, c, v


def _round_layouts(obj, block: Optional[Tuple[int, int]] = None
                   ) -> List[_Layout]:
    """The slot layout of every round of a FleetTopology (one) or a
    FleetSchedule (``period``), its padding triplets dropped; of the rows
    ``block = (lo, k)`` only, when given."""
    if isinstance(obj, FleetTopology):
        return [_coo_slots(obj.n, obj.rows, obj.cols, obj.vals, block)]
    return [_coo_slots(obj.n, obj.rows[t, :live], obj.cols[t, :live],
                       obj.vals[t, :live], block)
            for t, live in enumerate(obj.round_nnz)]


def _layouts_on(layouts: List[_Layout]):
    """``(device, t) -> round t's layout as tensors on device``: made on a
    device at its first use there and kept; ``t`` is a host int."""
    on_device: Dict[torch.device, list] = {}

    def at(device: torch.device, t: int):
        tables = on_device.get(device)
        if tables is None:
            tables = on_device[device] = [
                (None if rank is None else torch.as_tensor(rank).to(device),
                 ks, torch.as_tensor(c).to(device),
                 torch.as_tensor(v).to(device)[:, None])
                for rank, ks, c, v in layouts]
        return tables[t % len(tables)]

    return at


def _coo_apply(layout, x: torch.Tensor,
               rows: Optional[int] = None) -> torch.Tensor:
    """``W @ x`` for an ``(n, d)`` f32 ``x`` and one round's device
    layout (of ``rows`` rows of W, all n when None): every row's terms
    added onto +0.0 in the reference's order, in f32.  One gather and one
    product over all the triplets (an ``(nnz, d)`` f32 temporary), then one
    add a slot."""
    rank, ks, cols, vals = layout
    prod = vals * x.index_select(0, cols)
    acc = x.new_zeros((x.shape[0] if rows is None else rows,) + x.shape[1:])
    off = 0
    for k in ks:
        acc[:k].add_(prod[off:off + k])
        off += k
    return acc if rank is None else acc.index_select(0, rank)


def _coo_leaves(layout, leaves, rows: Optional[int] = None):
    """Apply W (its ``rows`` rows, all when None) to agent-stacked
    ``leaves``: their f32 columns side by side in one ``(n, d)`` matrix
    (each column's sum is its own, so this is the reference's apply leaf by
    leaf), cast back to each leaf's dtype."""
    n = leaves[0].shape[0]
    cols = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
    mixed = _coo_apply(layout, cols[0] if len(cols) == 1
                       else torch.cat(cols, dim=1), rows)
    out, start = [], 0
    for leaf, col in zip(leaves, cols):
        width = col.shape[1]
        out.append(mixed[:, start:start + width]
                   .reshape((mixed.shape[0],) + tuple(leaf.shape[1:]))
                   .to(leaf.dtype))
        start += width
    return out


def _coo_tree(layout, tree):
    """Apply W to every leaf of an agent-stacked tree
    (:func:`_coo_leaves`)."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten(_coo_leaves(layout, leaves))


def _fleet_block(n: int, group) -> int:
    """k = n / ranks, the agents a rank holds; refused unless it divides,
    as pjit refuses an axis that does not."""
    if n % group.n_agents:
        raise ValueError(f"a fleet of {n} agents does not divide over "
                         f"{group.n_agents} ranks")
    return n // group.n_agents


def _coo_process_mixer(obj, group, time_varying: bool):
    """The COO slots with a fleet's k agents a rank: every leaf is
    all-gathered (a call's leaves in one message) and the rank applies the
    slots of its own rows ``[index * k, (index + 1) * k)``, laid out once
    from the one-card triplets of those rows in COO order with global
    columns, so each row adds its terms in the one-card order."""
    k = _fleet_block(obj.n, group)
    layout_at = _layouts_on(_round_layouts(obj, (group.index * k, k)))

    def gather(leaves):
        _check_block(leaves, k)
        mix.shipped_nbytes = group.n_agents * _nbytes(leaves)
        return gather_blocks(group, leaves)

    def mix(tree, t=None):
        if time_varying and t is None:
            raise ValueError("time-varying fleet mixer needs the round "
                             "index (pass t=state.step)")
        leaves, treedef = tree_flatten(tree)
        layout = layout_at(leaves[0].device, 0 if t is None else t)
        return treedef.unflatten(_coo_leaves(layout, gather(leaves), k))

    def push(tree, wvec, t=None):
        if time_varying and t is None:
            raise ValueError("time-varying fleet mixer needs the round "
                             "index (pass t=state.step)")
        leaves, treedef = tree_flatten(tree)
        *full, full_w = gather(leaves + [wvec])
        layout = layout_at(wvec.device, 0 if t is None else t)
        w_m = _coo_apply(layout, full_w.to(torch.float32)[:, None], k)
        return (treedef.unflatten(_coo_leaves(layout, full, k)),
                w_m[:, 0].to(wvec.dtype))

    mix.push = push
    mix.shipped_nbytes = 0
    return mix


def make_fleet_mixer(obj: Union[Topology, TopologySchedule, FleetTopology,
                                FleetSchedule],
                     dense_gate: int = FLEET_DENSE_GATE, group=None):
    """Mixer over a fleet of simulated agents.

    ``obj`` is a dense :class:`Topology` / :class:`TopologySchedule`
    (small n: the port's dense mixer on the same table, so the fleet path
    is bitwise the per-device engine) or a sparse :class:`FleetTopology` /
    :class:`FleetSchedule` (the COO slots; the (n, n) table is never
    made).  A FleetTopology / FleetSchedule with ``n <= dense_gate`` is
    densified back onto the dense path; ``dense_gate=0`` forces the COO
    path (tests).

    ``group``: an agent group of P ranks (:class:`repro_torch.launch.mesh.
    AgentGroup`), the fleet axis sharded over them as pjit lays it out:
    rank r holds agents ``[r k, (r + 1) k)``, k = n / P.  Every mix then
    all-gathers the rank's blocks (one message for all leaves) and the rank
    keeps its rows of the one-card product: below the gate the dense
    process executor's whole ``W_t @ C``
    (:func:`repro_torch.core.gossip.make_dense_process_mixer`), above it
    the COO slots of its own rows only.  Each row is bitwise the one-card
    fleet's.  The budget is one all-gather, and ``mix.shipped_nbytes``
    every agent's bytes, as the dense process executor reports them.

    The mixer has the dense mixer's surface: ``mix(tree[, t])``,
    ``mix.push(tree, wvec, t)`` (the (n,) push-sum weight mixed by the same
    W_t, in its own product), ``time_varying``, ``n``, ``budget``,
    ``wire_mode = "dense"``, ``wire_frac = None``, ``schedule``, ``group``
    and ``n_agents``.  A time-varying mixer takes the host int round index
    and picks its round's device tables with it: no sync.
    """
    if isinstance(obj, (Topology, TopologySchedule)):
        w = obj.ws if isinstance(obj, TopologySchedule) else obj.w
        n = int(np.shape(w)[-1])
        mix = (make_dense_mixer(w) if group is None else
               make_dense_process_mixer(w, group, _fleet_block(n, group)))
        time_varying = mix.time_varying
        note = (f"fleet dense-gate (n={n} <= {dense_gate}): the dense "
                "mixer, bitwise the per-device engine")
    elif isinstance(obj, (FleetTopology, FleetSchedule)):
        n = obj.n
        time_varying = isinstance(obj, FleetSchedule)
        if n <= dense_gate:
            dense = (np.stack([obj.densify(t) for t in range(obj.period)])
                     if time_varying else obj.densify())
            mix = (make_dense_mixer(dense) if group is None else
                   make_dense_process_mixer(dense, group,
                                            _fleet_block(n, group)))
            note = f"fleet dense-gate (n={n} <= {dense_gate}), COO densified"
        elif group is not None:
            mix = _coo_process_mixer(obj, group, time_varying)
            mix.time_varying = time_varying
            note = (f"fleet COO slots (n={n}, nnz={obj.rows.size}) of a "
                    "rank's rows after one all-gather")
        else:
            layout_at = _layouts_on(_round_layouts(obj))

            if time_varying:
                def mix(tree, t):
                    leaf = tree_flatten(tree)[0][0]
                    return _coo_tree(layout_at(leaf.device, t), tree)
            else:
                def mix(tree, t=None):
                    leaf = tree_flatten(tree)[0][0]
                    return _coo_tree(layout_at(leaf.device, 0), tree)

            def push(tree, wvec, t=None):
                if time_varying and t is None:
                    raise ValueError("time-varying fleet mixer needs the "
                                     "round index (pass t=state.step)")
                layout = layout_at(wvec.device, 0 if t is None else t)
                w_m = _coo_apply(layout, wvec.to(torch.float32)[:, None])
                return mix(tree, t), w_m[:, 0].to(wvec.dtype)

            mix.push = push
            mix.time_varying = time_varying
            note = (f"fleet COO slots (n={n}, nnz={obj.rows.size}): local "
                    "math over the fleet axis")
    else:
        raise TypeError(f"make_fleet_mixer: unsupported table type "
                        f"{type(obj).__name__}")

    mix.n = n
    mix.budget = GossipBudget(
        executor="fleet", per_leaf={} if group is None else {"all-gather": 1},
        spmd_dependent=True, note=note)
    mix.wire_mode = "dense"
    mix.wire_frac = None
    mix.schedule = obj if time_varying else None
    mix.group = group
    mix.n_agents = n
    return mix
