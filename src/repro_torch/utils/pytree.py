"""Small helpers over parameter trees: nested dicts, lists and tuples whose
leaves are tensors (the port's stand-in for JAX pytrees)."""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply fn leaf-wise over trees of one structure (dict keys in the
    first tree's order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """Leaves in the order tree_map visits them."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """Inverse of tree_leaves: put `leaves` into the structure of `like`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_weighted_sum(trees, weights):
    """sum_i weights[i] * trees[i] — used by weighted FL aggregation. Summed
    left to right, as the reference does."""
    if not trees or len(trees) != len(weights):
        raise ValueError("need one weight per tree and at least one tree")
    out = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_add(out, tree_scale(t, w))
    return out
