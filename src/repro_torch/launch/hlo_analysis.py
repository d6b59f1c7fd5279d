"""Collective traffic and op counts of the port's steps.

Counterpart of ``repro.launch.hlo_analysis``. The reference parses the
collectives out of XLA's partitioned HLO text, because XLA's cost analysis
reports FLOPs and HBM bytes but not collective traffic. The port runs
eagerly and has no HLO: it counts the collectives it actually issues. Every
one goes through `launch.mesh.all_gather_rows` or `launch.mesh.all_reduce_`
(their callers: `kernels/sharded.py`, `fl/sharded.py`, the length-sharded
decode in `models/attention.py`, and `launch.sharding.gather_tree`), which
report to the open `collective_stats()` blocks. The HLO text parser is not
carried over (docs/port.md).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Sequence

import torch

from repro_torch.launch import mesh as _mesh


@contextlib.contextmanager
def collective_stats():
    """Yields {kind: {"count", "bytes"}}, filled with every collective the
    block issues on this rank, summing OUTPUT bytes per op as the reference
    does: for an all-gather the gathered tensor, for an all-reduce the
    reduced one (each the per-rank traffic up to the ring's (n-1)/n
    factor)."""
    stats: Dict[str, Dict[str, int]] = {}
    _mesh._STATS.append(stats)
    try:
        yield stats
    finally:
        _mesh._STATS.remove(stats)


def shape_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes of a tensor of `shape` and `dtype`."""
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def total_collective_bytes(stats: Mapping[str, Mapping[str, int]]) -> int:
    return int(sum(v["bytes"] for v in stats.values()))


def count_op(op_counts: Mapping[str, int], opcode: str) -> int:
    """How many aten ops named `opcode` (any overload: "mm", "bmm",
    "addmm") a dry run dispatched; op_counts is its record
    (`launch.dryrun.count_step`'s "ops")."""
    return int(sum(n for name, n in op_counts.items()
                   if name.split(".")[0] == opcode))
