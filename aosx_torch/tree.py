"""Maps over nested state (what ``jax.tree_util`` does for ``aosx``).

A tree is a dataclass, dict, tuple or list whose leaves are tensors; None
stays None. ``stack``/``cat``/``lane``/``scatter`` add, join, read and
replace a leading lane axis on every leaf.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and of ``rest``, trees of the same
    structure), rebuilt into the structure of ``tree``."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def stack(trees):
    """Trees of one structure stacked on a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def cat(trees):
    """Lane-stacked trees joined along the lane axis."""
    return tree_map(lambda *xs: torch.cat(xs), *trees)


def lane(tree, i):
    """Lane(s) ``i`` (an int, a slice or an index tensor) of every leaf."""
    return tree_map(lambda x: x[i], tree)


def scatter(tree, idx, new):
    """``tree`` with lanes ``idx`` of every leaf replaced by ``new``'s. Out of
    place: two fields of a state may hold one tensor (the accumulator's
    last_xy is the robot's xy), which an in-place write would hit twice."""
    return tree_map(lambda a, b: a.index_copy(0, idx, b), tree, new)
