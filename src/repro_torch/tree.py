"""Minimal pytree helpers over dicts, tuples, lists and NamedTuples.

The port's state is plain dicts of tensors and NamedTuples of them.  Leaf
order follows ``jax.tree_util``: dict entries in sorted-key order, sequence
entries in position order, ``None`` as an empty subtree.  Keeping that order
is what makes the flat planes of :mod:`repro_torch.kernels.flatten` equal to
the reference's element for element.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_leaves", "tree_unflatten",
           "tree_map"]


class TreeDef(NamedTuple):
    """Structure of a tree; ``kind`` is None for a leaf."""

    kind: Any
    keys: Tuple[Any, ...]
    children: Tuple["TreeDef", ...]

    def unflatten(self, leaves):
        return tree_unflatten(self, leaves)


_LEAF = TreeDef(None, (), ())


def _flatten(tree, leaves: List[Any]) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef(dict, keys,
                       tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        return TreeDef(type(tree), (),
                       tuple(_flatten(c, leaves) for c in tree))
    if tree is None:
        return TreeDef(type(None), (), ())
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def _build(treedef: TreeDef, it):
    if treedef.kind is None:
        return next(it)
    if treedef.kind is dict:
        return {k: _build(c, it) for k, c in zip(treedef.keys,
                                                   treedef.children)}
    if treedef.kind is type(None):
        return None
    children = [_build(c, it) for c in treedef.children]
    if hasattr(treedef.kind, "_fields"):
        return treedef.kind(*children)
    return treedef.kind(children)


def tree_unflatten(treedef: TreeDef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("too many leaves for this tree structure")
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError("tree_map needs trees of one structure")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
