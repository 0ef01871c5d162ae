"""Flat tile-plane layout: tree <-> padded ``(tiles, 8*1024)`` planes.

The fused error-feedback kernels run over one flat plane per buffer tree:
every leaf of an agent-stacked tree is flattened per agent row, the rows
are concatenated in tree order, zero-padded to a multiple of ``TILE`` and
viewed as a ``(rows * tiles, TILE)`` plane, so one launch covers every
(agent, leaf) pair.  :func:`from_planes` drops the pad and restores each
leaf's shape and dtype.  The layout is the reference's
(``src/repro/kernels/flatten.py``) element for element.

Per-shard planes (:class:`ShardedFlatSpec`, the reference's ``:185``):
on a grid with a model axis each rank packs only its local block -- its
agent row, its shard of every model-sharded leaf, the replicated leaves
whole -- into its own plane, padded on its own; every rank of one grid
has the same local shapes, so the same layout.  The ef updates are
elementwise, so on per-shard planes they are the one-card update element
for element.  :meth:`ShardedFlatSpec.block` cuts a rank's block out of a
one-card plane (the SR words drawn at the one-card shape).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tree import TreeDef, tree_flatten, tree_leaves

__all__ = ["TILE", "FlatSpec", "flat_spec", "to_planes", "from_planes",
           "derived_plane_dtype", "plane_apply", "leaf_ranges",
           "ShardedFlatSpec", "specs_have_model_axes", "sharded_spec"]

TILE = 8 * 1024


class FlatSpec(NamedTuple):
    """Static description of a tree's flat layout (per row).

    ``rows`` is the leading (agent) axis size, or 0 for an unstacked tree;
    ``shapes``/``dtypes``/``sizes`` describe each leaf without the row axis;
    ``d`` is the per-row element count and ``tiles`` the number of TILE-sized
    plane rows each logical row occupies.
    """

    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    rows: int
    d: int
    tiles: int
    plane_dtype: torch.dtype = torch.float32

    @property
    def padded(self) -> int:
        return self.tiles * TILE

    @property
    def plane_shape(self) -> Tuple[int, int]:
        return (max(self.rows, 1) * self.tiles, TILE)


def derived_plane_dtype(tree) -> torch.dtype:
    """The promotion of all leaf dtypes (f32 for a mixed bf16+f32 tree)."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("cannot derive a plane dtype for an empty tree")
    dt = leaves[0].dtype
    for leaf in leaves[1:]:
        dt = torch.promote_types(dt, leaf.dtype)
    return dt


def flat_spec(tree, stacked: bool = True, plane_dtype: Any = None) -> FlatSpec:
    """Compute the flat layout of ``tree``.

    stacked: leaves carry a shared leading agent axis, which becomes
    ``spec.rows``.  plane_dtype: storage dtype of the plane; None derives it
    with :func:`derived_plane_dtype`.
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot flatten an empty tree")
    if stacked:
        rows = leaves[0].shape[0] if leaves[0].dim() else -1
        for leaf in leaves:
            if leaf.dim() < 1 or leaf.shape[0] != rows:
                raise ValueError(
                    "stacked flatten needs a shared leading agent axis; got "
                    f"shapes {[tuple(x.shape) for x in leaves]}")
        shapes = tuple(tuple(leaf.shape[1:]) for leaf in leaves)
    else:
        rows = 0
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    d = sum(sizes)
    tiles = -(-d // TILE)
    if plane_dtype is None:
        plane_dtype = derived_plane_dtype(tree)
    return FlatSpec(treedef=treedef, shapes=shapes,
                    dtypes=tuple(leaf.dtype for leaf in leaves), sizes=sizes,
                    rows=rows, d=d, tiles=tiles, plane_dtype=plane_dtype)


def to_planes(tree, spec: FlatSpec) -> torch.Tensor:
    """Pack ``tree`` into a contiguous ``spec.plane_dtype`` plane."""
    pdt = spec.plane_dtype
    leaves = tree_leaves(tree)
    lead = (spec.rows,) if spec.rows else ()
    parts = [leaf.reshape(lead + (-1,)).to(pdt) for leaf in leaves]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    flat = F.pad(flat, (0, spec.padded - spec.d))
    return flat.reshape(spec.plane_shape).contiguous()


def from_planes(planes: torch.Tensor, spec: FlatSpec):
    """Invert :func:`to_planes`: drop padding, split leaves, restore dtypes.

    Leaves come back contiguous, laid out as the leafwise path lays them
    out: a matrix product's rounding may depend on its operands' strides,
    so the plane path and the leafwise path stay bit-identical only when
    their buffers share a layout.
    """
    lead = (spec.rows,) if spec.rows else ()
    flat = planes.reshape(lead + (spec.padded,))[..., :spec.d]
    offs, out = 0, []
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaf = flat[..., offs:offs + size]
        out.append(leaf.reshape(lead + shape).to(dtype).contiguous())
        offs += size
    return spec.treedef.unflatten(out)


def plane_apply(kernel, trees: Sequence[Any], n_out: int):
    """Run ``kernel`` over the flat planes of same-structure ``trees``.

    kernel: ``(plane, ...) -> (plane, ...)`` with ``n_out`` outputs; output
    ``i`` is unpacked with the layout (and leaf dtypes) of ``trees[i]``.
    One pack per tree, one kernel call, one unpack per output.
    """
    specs = [flat_spec(t) for t in trees]
    outs = kernel(*(to_planes(t, s) for t, s in zip(trees, specs)))
    return tuple(from_planes(o, specs[i]) for i, o in enumerate(outs[:n_out]))


def leaf_ranges(spec: FlatSpec):
    """Each leaf's ``(start, stop)`` in a row of ``spec``'s flat layout."""
    out, off = [], 0
    for size in spec.sizes:
        out.append((off, off + size))
        off += size
    return out


# ---------------------------------------------------------------------------
# per-shard planes
# ---------------------------------------------------------------------------

def _spec_names(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def specs_have_model_axes(leaf_specs,
                          agent_axes: Sequence[str] = ("data",)) -> bool:
    """True when any leaf spec (a :class:`repro_torch.nn.module.Spec`)
    shards a non-agent (model) axis."""
    agent = set(agent_axes)
    return any(any(n not in agent for e in s.entries for n in _spec_names(e))
               for s in tree_leaves(leaf_specs))


class ShardedFlatSpec(NamedTuple):
    """Where the per-shard planes live: the rank's agent ``group`` (with
    its model axis), the per-leaf specs (the agent axes first, one entry:
    :func:`repro_torch.nn.module.prepend_axis_specs`) and the planes'
    dtype (None: each tree's own).  The local :class:`FlatSpec` of a
    tree comes from its local leaves (:func:`flat_spec`)."""

    group: Any
    leaf_specs: Any
    plane_dtype: Any = None

    def dims(self):
        """Each leaf's model-sharded dimension in the agent-stacked leaf,
        or None for a replicated leaf (tree order)."""
        return [s.model_dim for s in tree_leaves(self.leaf_specs)]

    def shards(self):
        """Each leaf's model shards: the model axis's size for a sharded
        leaf, 1 for a replicated one (tree order)."""
        m = self.group.model_size
        return [1 if d is None else m for d in self.dims()]

    def counted(self):
        """Per leaf: whether this rank counts it in a sum over the whole
        replica (a norm, a consensus error): its shard, or a replicated
        leaf on model rank 0 only."""
        first = self.group.model_index == 0
        return [d is not None or first for d in self.dims()]

    def global_layout(self, local: FlatSpec) -> FlatSpec:
        """The one-card layout of all agents' whole leaves beside a rank's
        local layout ``local``."""
        shapes = tuple(s.shape for s in tree_leaves(self.leaf_specs))
        sizes = tuple(math.prod(s) for s in shapes)
        d = sum(sizes)
        return local._replace(shapes=shapes, sizes=sizes, d=d,
                              rows=self.group.n_agents,
                              tiles=-(-d // TILE))

    def block(self, full: torch.Tensor, local: FlatSpec) -> torch.Tensor:
        """This rank's plane (layout ``local``, one agent row) cut out of
        the one-card plane ``full`` (layout :meth:`global_layout`): its
        agent's row, its shard of every sharded leaf, the replicated leaves
        whole, packed and padded with zeros as :func:`to_planes` does."""
        from ..core.agents import model_shard
        g = self.global_layout(local)
        group = self.group
        row = full.reshape(g.rows, g.padded)[group.index, :g.d]
        parts = []
        for (lo, hi), shape, dim in zip(leaf_ranges(g), g.shapes,
                                        self.dims()):
            leaf = row[lo:hi].reshape(shape)
            leaf = model_shard(leaf, None if dim is None else dim - 1,
                               group.model_index, group.model_size)
            parts.append(leaf.reshape(-1))
        flat = F.pad(torch.cat(parts), (0, local.padded - local.d))
        return flat.reshape(local.plane_shape).contiguous()


def sharded_spec(group, leaf_specs, plane_dtype: Any = None
                 ) -> ShardedFlatSpec:
    """Pin the per-shard plane layout of ``group``'s ranks."""
    if group is None or leaf_specs is None:
        raise ValueError("per-shard planes need both a group and leaf_specs")
    return ShardedFlatSpec(group=group, leaf_specs=leaf_specs,
                           plane_dtype=plane_dtype)
