"""Observability surface of the parameter service (DESIGN.md §14, §16).

One `ServiceMetrics` object per service, built on the general
`repro_torch.obs.registry.MetricsRegistry`: rolling counters
(dispatches, submits, aggregations, expiries, rejects-by-reason) in a
CounterVec, wire bytes in gauges, the staleness histogram in an
IntHistogram, wall-clock latency reservoirs for the dispatch / submit /
checkpoint paths, and a bounded per-event structured log. The
deterministic part (counters, histogram, bytes) is checkpointed with the
service so a restored run reports the same cumulative totals; wall-clock
latencies and the event log are process-local observability and are
not. The legacy attribute surface (`counts`, `staleness`, `up_bytes`,
`dispatch_s`, ...) is kept as properties over the registry instruments,
and `pack()`/`unpack()` emit the reference's structure, so service
checkpoints keep the reference's metrics schema (pinned in
tests/test_torch_obs_service.py against the committed serve_load artifact
schema).

`snapshot()` reports rates over the current *measurement window* —
`reset_window()` restarts the window (after jit warmup, say) without
discarding the cumulative counters. `dump()` is byte-deterministic for
identical state: sorted keys, floats rounded explicitly, and unexpected
types raise instead of being silently stringified.
"""
from __future__ import annotations

import json
import time
from collections import Counter, deque
from pathlib import Path
from typing import Dict, Optional

from repro_torch.obs.registry import (MetricsRegistry,  # noqa: F401
                                      latency_stats)

#: counters describing this *process* (how many times it checkpointed or
#: restored), not the served stream — excluded from the checkpointed
#: deterministic slice so a restored run's counters stay bit-identical
#: to an uninterrupted one's
LOCAL_COUNT_KEYS = ("checkpoint", "restore")

#: decimal places `dump()` rounds floats to (event-log + snapshot floats
#: are already rounded at source; this is the backstop that makes the
#: artifact byte-stable whatever lands in it)
DUMP_DECIMALS = 6


def _jsonable(obj, _depth: int = 0):
    """Deterministic JSON sanitizer: rounds floats, passes JSON natives,
    and *raises* on anything else — `default=str` used to stringify
    surprises (numpy scalars, arrays) silently and unstably."""
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        return round(obj, DUMP_DECIMALS)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, _depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v, _depth + 1) for v in obj]
    # numpy ints/floats quack via .item(); anything else is a bug upstream
    item = getattr(obj, "item", None)
    if callable(item) and getattr(obj, "ndim", 1) == 0:
        return _jsonable(item(), _depth + 1)
    raise TypeError(f"non-JSON-serializable metrics value {obj!r} "
                    f"({type(obj).__name__}) — round/convert it at source")


class ServiceMetrics:
    def __init__(self, event_log_size: int = 2000, reservoir_size: int = 8192,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._counts = r.counter_vec("service.counts")
        self._staleness = r.int_histogram("service.staleness")
        self._up_bytes = r.gauge("service.up_bytes")
        self._down_bytes = r.gauge("service.down_bytes")
        self._dispatch = r.reservoir("service.dispatch_s", reservoir_size)
        self._submit = r.reservoir("service.submit_s", reservoir_size)
        self._checkpoint = r.reservoir("service.checkpoint_s", reservoir_size)
        self.events: deque = deque(maxlen=event_log_size)
        self._jsonl = None
        self.reset_window()

    # legacy attribute surface over the registry instruments ----------- #
    @property
    def counts(self) -> Counter:
        return self._counts.values

    @counts.setter
    def counts(self, c) -> None:
        self._counts.values.clear()
        self._counts.values.update(c)

    @property
    def staleness(self) -> Counter:
        return self._staleness.counts

    @property
    def up_bytes(self) -> float:
        return self._up_bytes.value

    @up_bytes.setter
    def up_bytes(self, v: float) -> None:
        self._up_bytes.value = float(v)

    @property
    def down_bytes(self) -> float:
        return self._down_bytes.value

    @down_bytes.setter
    def down_bytes(self, v: float) -> None:
        self._down_bytes.value = float(v)

    @property
    def dispatch_s(self) -> deque:
        return self._dispatch.samples

    @property
    def submit_s(self) -> deque:
        return self._submit.samples

    @property
    def checkpoint_s(self) -> deque:
        return self._checkpoint.samples

    # ------------------------------------------------------------------ #
    def bump(self, name: str, n: int = 1) -> None:
        self._counts.inc(name, n)

    def note_staleness(self, tau: int) -> None:
        self._staleness.observe(int(tau))

    def log(self, now: float, kind: str, **fields) -> None:
        ev = {"t": round(float(now), 6), "event": kind, **fields}
        self.events.append(ev)
        if self._jsonl is not None:
            self._jsonl.write(_jsonable(ev))

    def attach_jsonl(self, sink) -> None:
        """Tee every `log()` event into a
        `repro_torch.obs.export.JsonlEventLog` (or anything with a
        `write(dict)`), in addition to the bounded in-memory deque. Pass
        None to detach."""
        self._jsonl = sink

    def prometheus(self, namespace: str = "hapfl",
                   const_labels: Optional[Dict[str, str]] = None) -> str:
        """This registry in the Prometheus text exposition format
        (repro_torch.obs.export.prometheus_text) — the scrape surface."""
        from repro_torch.obs.export import prometheus_text
        return prometheus_text(self.registry, namespace=namespace,
                               const_labels=const_labels)

    def reset_window(self) -> None:
        """Restart the rate window: clears the latency reservoirs and the
        throughput baseline, keeps cumulative counters/bytes/histogram."""
        self._t0 = time.perf_counter()
        self._window_base = Counter(self.counts)
        self._dispatch.reset()
        self._submit.reset()
        self._checkpoint.reset()

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict:
        wall = time.perf_counter() - self._t0
        win = {k: self.counts[k] - self._window_base.get(k, 0)
               for k in self.counts}
        ups = win.get("submit", 0)
        return {
            "counts": dict(self.counts),
            "window_counts": win,
            "window_wall_seconds": round(wall, 3),
            "updates_per_sec": (round(ups / wall, 2) if wall > 0 else None),
            "aggregations_per_sec": (round(win.get("aggregate", 0) / wall, 2)
                                     if wall > 0 else None),
            "up_bytes": round(self.up_bytes, 1),
            "down_bytes": round(self.down_bytes, 1),
            "staleness_hist": {str(k): int(v)
                               for k, v in sorted(self.staleness.items())},
            "dispatch": self._dispatch.stats(),
            "submit": self._submit.stats(),
            "checkpoint": self._checkpoint.stats(),
        }

    def dump(self, path) -> None:
        """Write the snapshot + the structured event log as one artifact.
        Byte-deterministic for identical state: keys sorted, floats
        rounded, non-JSON types rejected loudly."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            _jsonable({"snapshot": self.snapshot(),
                       "events": list(self.events)}),
            indent=1, sort_keys=True))

    # checkpointed (deterministic) slice ------------------------------- #
    def deterministic_counts(self) -> Dict[str, int]:
        """Counters that depend only on the served event stream (the
        process-local LOCAL_COUNT_KEYS dropped) — the slice that must
        match bit-for-bit across checkpoint/restore."""
        return {k: int(v) for k, v in self.counts.items()
                if k not in LOCAL_COUNT_KEYS}

    def pack(self) -> Dict:
        return {"counts": self.deterministic_counts(),
                "staleness": {str(k): int(v)
                              for k, v in self.staleness.items()},
                "up_bytes": self.up_bytes, "down_bytes": self.down_bytes}

    def unpack(self, state: Dict) -> None:
        self.counts = Counter(state["counts"])
        self._staleness.unpack(state["staleness"])
        self.up_bytes = float(state["up_bytes"])
        self.down_bytes = float(state["down_bytes"])
        self.reset_window()
