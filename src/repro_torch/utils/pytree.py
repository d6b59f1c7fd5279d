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


# --------------------------------------------------------------------- #
# jax.tree_util's leaf order
# --------------------------------------------------------------------- #
def tree_flatten_sorted(tree):
    """(leaves, treedef) in jax.tree_util's order: a dict's children by
    sorted key, lists and tuples in order, None an empty node. Where a
    leaf's index feeds a random stream (the codecs' rounding entropy,
    `service.loadgen.synth_update`'s noise), only this order draws what the
    reference draws; `tree_leaves` keeps insertion order."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [tree_flatten_sorted(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                (dict, keys, tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten_sorted(x) for x in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree), len(tree), tuple(d for _, d in parts)))
    if tree is None:
        return [], None
    return [tree], "*"


def tree_unflatten_sorted(treedef, leaves):
    """Inverse of `tree_flatten_sorted` (dicts come back with sorted keys,
    as jax.tree_util's do)."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, keys, kids = d
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, kids)}
        return kind(build(c) for c in kids)
    return build(treedef)


def tree_paths_sorted(tree, prefix: str = ""):
    """[(path, leaf)] in `tree_flatten_sorted`'s order. A path joins the
    dict keys and list indices above a leaf with "/", as the reference's
    checkpoint keys do (a leaf at the root has the path "")."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_paths_sorted(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in tree_paths_sorted(x, join(i))]
    if tree is None:
        return []
    return [(prefix, tree)]
