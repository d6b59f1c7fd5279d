"""What every job of the benchmark shares: finding a cell, a configuration,
a job and a per-layer metric by name; the program's model configuration
made from a configuration file; the reduction of a `torch.profiler` slice
to busy time, time by kernel and idle gaps; and the statistics.

Files are found by name, so a later change adds a cell, a configuration or
a metric as a new file: `workloads/<cell>.json`, `configs/<config>.json`,
`jobs/<job>.py` (a `make(ctx)` function returning the job: `setup`,
`window`, `traced`, `e2e`, `attempted`, `free`, `judge`),
`metrics/<metric>.py` (a `read(rec)` function returning a number, or None
where the run recorded nothing it can read).
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    """`base/<kind>/<name>.json` ("configs" or "workloads")."""
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, base: Path = HERE):
    """The module in `base/<kind>/<name>.py` ("jobs" or "metrics"), loaded
    from its file (a metric's name may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(man: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that `cell`
    reports: those that list it under "workloads", or list none."""
    def mine(entries):
        return [m for m in entries
                if "workloads" not in m or cell in m["workloads"]]
    return mine(man["end_to_end"]), mine(man["per_layer"])


def program_config(spec, name: str, remat: bool = True):
    """The program's `ModelConfig` of a reference Spec: the same sizes under
    the program's field names."""
    import torch
    from repro_torch.configs.base import ModelConfig
    family = ("moe" if spec.experts else
              "vlm" if spec.embeddings_in else "dense")
    return ModelConfig(
        name=name, family=family, n_layers=spec.layers, d_model=spec.d,
        n_heads=spec.heads, n_kv_heads=spec.kv_heads, d_ff=spec.ff,
        vocab_size=spec.vocab, head_dim=spec.head_dim,
        n_experts=spec.experts, top_k=spec.top_k, moe_d_ff=spec.moe_ff,
        capacity_factor=spec.capacity_factor, rope_theta=spec.rope_theta,
        mrope_sections=spec.mrope,
        input_mode="embeddings" if spec.embeddings_in else "tokens",
        tie_embeddings=spec.tie, dtype=getattr(torch, spec.dtype),
        remat=remat)


def mark(ctx, label: str) -> None:
    """Record how far set-up has come (run.py prints the marks)."""
    if hasattr(ctx, "marks"):
        ctx.marks.append((label, ctx.since_start()))


# ---------------------------------------------------------------------- #
# statistics
# ---------------------------------------------------------------------- #
def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by the intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union of the intervals, from the first start to
    the last end."""
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def label_gaps(gaps, host_ops: Sequence[Tuple[float, float, str]],
               top: int = 10) -> List[List]:
    """Idle time summed by what the host was doing at each gap's middle:
    the innermost host operation spanning it (the latest started), else
    "host (no operation)". The `top` largest, [label, seconds]."""
    ops = sorted(host_ops)
    starts = [o[0] for o in ops]
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        label = "host (no operation)"
        for j in range(i - 1, max(-1, i - 400), -1):
            if ops[j][1] >= mid:
                label = ops[j][2]
                break
        by[label] = by.get(label, 0.0) + (b - a)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in rows]


def sync(torch) -> None:
    """Wait for the card's queued work (nothing to wait for without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def alloc_counts(torch) -> Tuple[int, int]:
    """(retries, device mallocs) of PyTorch's caching allocator so far: a
    retry frees the cache and mallocs again, a slow host path."""
    if not torch.cuda.is_available():
        return 0, 0
    s = torch.cuda.memory_stats()
    return s.get("num_alloc_retries", 0), s.get("num_device_alloc", 0)


def profile(torch, fn: Callable[[], None], host: bool = False) -> dict:
    """Run fn() under torch.profiler and reduce the trace: wall_s (host
    clock, synchronised), busy_s (the union of the device's event
    intervals), kernels [(name, count, seconds)] by total time, and with
    `host`, gaps [[host label, seconds]]. Tracing the host's operations
    slows the host, so busy and idle time come from a trace without them
    (`host` False) and the gaps' labels from another."""
    from torch.profiler import ProfilerActivity
    on_card = torch.cuda.is_available()
    acts = (([ProfilerActivity.CPU] if host or not on_card else [])
            + ([ProfilerActivity.CUDA] if on_card else []))
    sync(torch)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch)
        wall = time.perf_counter() - t0
    dev, host = [], []
    by: Dict[str, List[float]] = {}
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the harness's own ranges also appear on the device's
            # timeline; they are no device work
            if b > a and not ev.name.startswith("portbench"):
                dev.append((a, b))
                row = by.setdefault(ev.name, [0, 0.0])
                row[0] += 1
                row[1] += (b - a) / 1e6
        elif b > a and ev.name.startswith(("aten::", "cuda", "portbench")):
            host.append((a, b, ev.name))
    busy = union_length(dev) / 1e6
    kernels = sorted(((k, c, s) for k, (c, s) in by.items()),
                     key=lambda r: -r[2])
    gaps = [(a / 1e6, b / 1e6) for a, b in idle_gaps(dev)]
    return {"wall_s": wall, "busy_s": busy, "kernels": kernels,
            "gaps": label_gaps(gaps, [(a / 1e6, b / 1e6, n)
                                      for a, b, n in host])}


def kernel_time(prof: dict, match: Callable[[str], bool]
                ) -> Tuple[int, float]:
    """(launches, device seconds) of the profiled kernels whose name
    matches."""
    n, s = 0, 0.0
    for name, count, sec in prof["kernels"]:
        if match(name):
            n += count
            s += sec
    return n, s


class Checks:
    """The numbers compared to decide `correct`, each beside its limit."""

    def __init__(self):
        self.rows: List[Tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.rows.append((name, float(value), float(limit)))

    def correct(self) -> bool:
        return bool(self.rows) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.rows)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.rows}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's |prog - ref| of norms over max(ref leaf, median ref
    leaf), over `leaves` (all of ref's when None)."""
    names = list(ref) if leaves is None else list(leaves)
    vals = sorted(ref[n] for n in names)
    med = vals[len(vals) // 2] if vals else 0.0
    out = {}
    for n in names:
        den = max(ref[n], med)
        out[n] = abs(prog[n] - ref[n]) / den if den > 0 else (
            0.0 if prog[n] == ref[n] else math.inf)
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[Sequence[str]] = None
                   ) -> Tuple[float, str]:
    """The widest of `leaf_gaps`: (gap, leaf)."""
    gaps = leaf_gaps(prog, ref, leaves)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median(values: Sequence[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2]
