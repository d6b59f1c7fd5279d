"""Logical-axis rules and the current mesh.

Counterpart of ``repro.launch.axes``. `use_axis_rules(mesh, rules)` makes a
mesh (`launch.mesh`) and its rules current for the code inside it; the
model reads them where the reference does: the MoE dispatch's group count
(`models.moe._moe_groups`) and the length-sharded decode
(`models.attention`). `logical_to_pspec` maps logical axis names to mesh
axes as the reference does, one tuple of mesh axes (or None) per dimension.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import axis_sizes

_STATE = {"mesh": None, "rules": None}

# Default logical-axis -> mesh-axis rules. A logical axis may map to a tuple
# of mesh axes (e.g. batch over (pod, data)).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qdim": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "cap": (),
    "inner": ("model",),
    "state": (),
    "cache_seq": ("data",),   # long-context decode: shard KV length
    "fsdp": ("data",),        # parameter FSDP axis
}


@contextlib.contextmanager
def use_axis_rules(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["rules"] = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _STATE.update(prev)


def current_mesh():
    return _STATE["mesh"]


def current_rules() -> Dict[str, Tuple[str, ...]]:
    return _STATE["rules"] or {}


def logical_to_pspec(names: Tuple[Optional[str], ...], mesh,
                     rules: Dict[str, Tuple[str, ...]], shape=None
                     ) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """Per dimension, the mesh axes its logical name shards over (None for
    a replicated dimension): the reference's PartitionSpec as a tuple. A
    mesh axis is used once; a dimension smaller than and not divisible by
    its axes' product stays replicated."""
    sizes = axis_sizes(mesh)
    axes = []
    used = set()
    for i, n in enumerate(names):
        if n is None:
            axes.append(None)
            continue
        mesh_axes = tuple(a for a in rules.get(n, ())
                          if a in sizes and a not in used)
        if shape is not None and mesh_axes:
            total = 1
            for a in mesh_axes:
                total *= sizes[a]
            if shape[i] % total != 0 and shape[i] < total:
                mesh_axes = ()
        used.update(mesh_axes)
        axes.append(mesh_axes if mesh_axes else None)
    return tuple(axes)


def shard(x, *names):
    """`x` unchanged. The reference annotates an activation with
    ``with_sharding_constraint`` for the XLA partitioner; eager PyTorch has
    no per-activation sharding constraint, so the port's model code runs
    replicated on every rank and splits work explicitly where the reference
    shards it (the length-sharded decode, the grouped MoE dispatch). The
    weights' placement is `launch/sharding.py`'s (`shard_tree`)."""
    return x
