"""Parameter / optimizer / batch / cache sharding rules (FSDP x TP), name
based, and the placement that applies them to tensors.

Counterpart of ``repro.launch.sharding``, rule for rule. "Column-parallel"
weights (input projections, up-projections, q/k/v) shard their output dim
on "model" and their input dim on "data" (FSDP); "row-parallel" weights
(down / out projections) the reverse; embeddings shard vocab on "model".
A dim is sharded only when its axis divides it: a dim not divisible stays
whole. MoE expert weights are expert-parallel on "model" when it divides
the expert count, else ff-sharded inside the experts (mixtral's 8 experts
on 16).

A spec is a tuple with one entry per dimension: None (whole), an axis name,
or a tuple of axis names (split major to minor), the reference's
``PartitionSpec`` as a tuple. Trees are the port's nested dicts (lists and
tuples too); a path is the tuple of keys down to a leaf. Every rule takes a
`DeviceMesh` or any object with ``axis_names`` and a ``shape`` mapping
(`MeshShape`, the reference's ``AbstractMesh``), so the rules run without a
process group.

The placement is the runtime counterpart of ``NamedSharding``: `shard_tree`
cuts each leaf to this rank's block, by its coordinates on the axes the
leaf's spec names; `gather_tree` rebuilds every leaf bit for bit through
`launch.mesh.all_gather_rows`, one sharded dimension at a time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.launch.mesh import all_gather_rows, axis_sizes

# last dim -> model, second-to-last -> data (fsdp)
COL_PARALLEL = {"wq", "wk", "wv", "w_up", "w_gate", "in_proj", "w_v", "w_z",
                "w_q", "w_k", "w_in", "head", "fc1"}
# last dim -> data (fsdp), second-to-last -> model
ROW_PARALLEL = {"wo", "w_down", "out_proj", "fc2"}
EMBED = {"embed"}
REPLICATED = {"scale", "bias", "a_log", "dt_bias", "d_skip", "conv_w",
              "conv_b", "b_gates", "r", "b", "router", "log_std",
              "conv", "fc1_b", "fc2_b"}

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, with no devices or ranks behind it: what the
    rules and the dry run need of a mesh."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _fits(dim: int, sizes: Mapping[str, int], axis: str) -> bool:
    return axis in sizes and dim % sizes[axis] == 0


def param_pspec(path: Tuple, leaf, mesh) -> Spec:
    names = [str(p) for p in path]
    name = names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    spec = [None] * nd
    sizes = axis_sizes(mesh)
    is_moe = any(n == "moe" for n in names)

    def assign(i, axis):
        if 0 <= i < nd and spec[i] is None and _fits(shape[i], sizes, axis):
            spec[i] = axis

    if name in REPLICATED or nd <= 1:
        return tuple(spec)
    if is_moe and name in ("w_up", "w_gate", "w_down") and nd >= 3:
        # (L, E, d, ff) / (L, E, ff, d): expert-parallel on model if
        # divisible, else tensor-parallel inside the expert on the ff dim
        e_dim = nd - 3
        if _fits(shape[e_dim], sizes, "model"):
            assign(e_dim, "model")
            assign(nd - 2, "data")
        else:
            ff_dim = nd - 2 if name == "w_down" else nd - 1
            assign(ff_dim, "model")
            assign(nd - 1 if ff_dim != nd - 1 else nd - 2, "data")
        return tuple(spec)
    if name in EMBED:
        # (V, d) or (nq, V, d): vocab -> model, d -> data
        assign(nd - 2, "model")
        assign(nd - 1, "data")
    elif name in COL_PARALLEL:
        assign(nd - 1, "model")
        assign(nd - 2, "data")
    elif name in ROW_PARALLEL:
        assign(nd - 2, "model")
        assign(nd - 1, "data")
    return tuple(spec)


def params_shardings(params_shape, mesh):
    """Params tree -> tree of specs."""
    return _map_with_path(lambda path, leaf: param_pspec(path, leaf, mesh),
                          params_shape)


def opt_shardings(opt_shape, params_shardings_tree, mesh):
    """AdamW's m and v mirror the param specs; the step scalar is
    replicated. (params_shardings_tree is unused, as in the reference.)"""
    def one(path, leaf):
        if leaf.dim() == 0:
            return ()
        return param_pspec(path[1:], leaf, mesh)
    return _map_with_path(one, opt_shape)


# --------------------------------------------------------------------- #
def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that divides the global batch."""
    sizes = axis_sizes(mesh)
    chosen = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def _batch_entry(mesh, batch: int):
    """The batch dimension's spec entry: None, one axis name, or a tuple of
    them (a one-axis tuple is its name, as PartitionSpec normalises it)."""
    ba = batch_axes(mesh, batch)
    return None if not ba else ba[0] if len(ba) == 1 else ba


def batch_shardings(batch_shape: Dict[str, Any], mesh, batch: int):
    spec_b = _batch_entry(mesh, batch)

    def one(path, leaf):
        if str(path[-1]) == "positions" and leaf.dim() == 3:   # (3, B, S)
            return (None, spec_b)
        return (spec_b,) + (None,) * (leaf.dim() - 1)
    return _map_with_path(one, batch_shape)


def cache_shardings(cache_shape, mesh, batch: int):
    """Decode caches: shard batch if divisible; KV heads / cache length on
    model / data when the batch axis is idle (long-context, batch=1)."""
    spec_b = _batch_entry(mesh, batch)
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        name = str(path[-1])
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if name in ("k", "v") and nd >= 4:
            # (..., B, L, KV, hd)
            b_dim, l_dim, kv_dim, hd_dim = nd - 4, nd - 3, nd - 2, nd - 1
            if spec_b:
                spec[b_dim] = spec_b
            elif _fits(shape[l_dim], sizes, "data"):
                spec[l_dim] = "data"     # flash-decode style length sharding
            if _fits(shape[kv_dim], sizes, "model"):
                spec[kv_dim] = "model"
            elif spec[l_dim] is None and _fits(shape[l_dim], sizes, "model"):
                # kv_heads not divisible: the cache LENGTH on model (only
                # softmax partials cross shards)
                spec[l_dim] = "model"
            elif _fits(shape[hd_dim], sizes, "model"):
                spec[hd_dim] = "model"
            return tuple(spec)
        if name == "ssm" and nd >= 4:
            # (..., B, H, n, P)
            b_dim, h_dim = nd - 4, nd - 3
            if spec_b:
                spec[b_dim] = spec_b
            if _fits(shape[h_dim], sizes, "model"):
                spec[h_dim] = "model"
            return tuple(spec)
        if name == "C" and nd >= 4:    # mlstm (..., B, H, Pk, P)
            if spec_b:
                spec[nd - 4] = spec_b
            if _fits(shape[nd - 1], sizes, "model"):
                spec[nd - 1] = "model"
            return tuple(spec)
        # conv states, n/m/h/c vectors: shard batch when possible
        if spec_b:
            for i, s in enumerate(shape):
                if s == batch:
                    spec[i] = spec_b
                    break
        return tuple(spec)
    return _map_with_path(one, cache_shape)


# --------------------------------------------------------------------- #
# the placement
# --------------------------------------------------------------------- #
def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one dimension's spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a DeviceMesh."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def block_index(entry, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[int, int]:
    """(index, count) of a rank's block along a dimension whose spec entry
    is `entry`: its axes split the dimension major to minor."""
    index, count = 0, 1
    for a in entry_axes(entry):
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of `shape` under `spec` (a
    spec shorter than the shape leaves the last dimensions whole)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(s // block_index(e, sizes, {a: 0 for a in sizes})[1]
                 for s, e in zip(shape, spec))


def shard_leaf(x: torch.Tensor, spec: Spec, mesh,
               coords: Mapping[str, int]) -> torch.Tensor:
    """The block of x at mesh coordinates `coords`, contiguous (a leaf that
    no axis splits is returned as it is)."""
    sizes = axis_sizes(mesh)
    out = x
    for dim, entry in enumerate(spec):
        index, count = block_index(entry, sizes, coords)
        if count > 1:
            per = x.shape[dim] // count
            out = out.narrow(dim, index * per, per)
    return out if out is x else out.contiguous()


def shard_tree(tree, specs, mesh, coords: Optional[Mapping[str, int]] = None):
    """Each leaf cut to the block of the rank at `coords` (this rank's on a
    DeviceMesh when None)."""
    coords = mesh_coords(mesh) if coords is None else coords
    return _zip_with_path(lambda x, spec: shard_leaf(x, spec, mesh, coords),
                          tree, specs)


def _zip_with_path(fn, tree, specs):
    """fn(leaf, spec) over a tree and its spec tree (a spec is a tuple, so
    the spec tree is walked by the data tree's structure)."""
    if isinstance(tree, dict):
        return {k: _zip_with_path(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_with_path(fn, v, s)
                          for v, s in zip(tree, specs))
    return fn(tree, specs)


def zip_specs(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree, in the tree's
    order."""
    pairs = []
    _zip_with_path(lambda x, spec: pairs.append((x, spec)), tree, specs)
    return pairs


def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block of it: per sharded dimension,
    all_gather_rows over its axes, minor to major."""
    sizes = axis_sizes(mesh)
    out = x
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if sizes[a] == 1:
                continue
            rows = out.movedim(dim, 0)
            out = all_gather_rows(rows, mesh, a).movedim(0, dim)
    return out if out is x else out.contiguous()


def gather_tree(local, specs, mesh):
    """Every leaf rebuilt whole, bit for bit, on every rank."""
    return _zip_with_path(lambda x, spec: gather_leaf(x, spec, mesh), local,
                          specs)


def tree_bytes(tree, specs=None, mesh=None) -> int:
    """Bytes of a tree's leaves, or, with specs and a mesh, of one rank's
    blocks of them (every rank's blocks are the same size)."""
    if specs is None:
        leaves = []
        _map_with_path(lambda p, x: leaves.append(x), tree)
        return sum(x.numel() * x.element_size() for x in leaves)
    return sum(math.prod(shard_shape(x.shape, spec, mesh)) * x.element_size()
               for x, spec in zip_specs(tree, specs))
