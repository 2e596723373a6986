"""Nested-dict parameter trees: the port's stand-in for jax pytrees.

A tree is a tensor (a leaf), ``None``, or a dict / list / tuple of trees.
Dict leaves are visited in insertion order, which every producer in the
port keeps fixed, so two trees of one structure flatten alike.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise across trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """Rebuild ``tree``'s structure from ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_size(tree: Any) -> int:
    """Total number of elements in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))
