"""Flat tile-plane layout: tree <-> padded ``(tiles, 8*1024)`` planes.

The fused error-feedback kernels run over one flat plane per buffer tree:
every leaf of an agent-stacked tree is flattened per agent row, the rows
are concatenated in tree order, zero-padded to a multiple of ``TILE`` and
viewed as a ``(rows * tiles, TILE)`` plane, so one launch covers every
(agent, leaf) pair.  :func:`from_planes` drops the pad and restores each
leaf's shape and dtype.  The layout is the reference's
(``src/repro/kernels/flatten.py``) element for element.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tree import TreeDef, tree_flatten, tree_leaves

__all__ = ["TILE", "FlatSpec", "flat_spec", "to_planes", "from_planes",
           "derived_plane_dtype", "plane_apply"]

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
