"""General metrics registry (DESIGN.md §16): the shared substrate that
`repro_torch.service.metrics.ServiceMetrics` is built on.

Instrument kinds:

  Counter        one monotone scalar (float) — `inc()`
  CounterVec     named counters backed by one `collections.Counter`
                 (what the service's per-event counts use)
  Gauge          one settable scalar — `set()` / `+=` via `.value`
  IntHistogram   exact counts keyed by integer value (staleness taus)
  Histogram      fixed-bucket float histogram — `observe()`
  Reservoir      bounded latency sample buffer (`deque(maxlen=…)`) with
                 p50/p99/mean/max stats in milliseconds

Every instrument has a deterministic `pack()`/`unpack()` state slice; the
registry's `pack(names=…)` concatenates them. Determinism convention:
pack output contains only JSON-native types with *sorted* key order, so
`json.dumps(pack(), sort_keys=True)` is byte-stable for identical state.
Reservoirs measure host wall time and are intentionally NOT part of a
registry pack unless asked for by name — a restored process's latency
profile is its own, not the dead process's (same rule ServiceMetrics has
always applied to its wall reservoirs).
"""
from __future__ import annotations

import math
from collections import Counter as _PyCounter
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np


def latency_stats(seconds) -> Optional[Dict[str, float]]:
    """p50/p99/mean/max of a latency sample buffer, in milliseconds."""
    seconds = list(seconds)
    if not seconds:
        return None
    ms = np.asarray(seconds) * 1e3
    return {"n": int(ms.size),
            "p50_ms": round(float(np.percentile(ms, 50)), 3),
            "p99_ms": round(float(np.percentile(ms, 99)), 3),
            "mean_ms": round(float(ms.mean()), 3),
            "max_ms": round(float(ms.max()), 3)}


class Instrument:
    kind = "instrument"

    def __init__(self, name: str):
        self.name = name

    def pack(self):
        raise NotImplementedError

    def unpack(self, state) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        self.unpack(type(self)(self.name).pack())


class Counter(Instrument):
    kind = "counter"

    def __init__(self, name: str):
        super().__init__(name)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def pack(self):
        return float(self.value)

    def unpack(self, state) -> None:
        self.value = float(state)


class CounterVec(Instrument):
    """Named counters sharing one `collections.Counter` — exposed raw so
    callers keep the ergonomic `vec.values[name] += 1` / `.get()` access
    the service code has always used."""

    kind = "counter_vec"

    def __init__(self, name: str):
        super().__init__(name)
        self.values: _PyCounter = _PyCounter()

    def inc(self, key: str, n: int = 1) -> None:
        self.values[key] += n

    def pack(self):
        return {str(k): self.values[k] for k in sorted(self.values)}

    def unpack(self, state) -> None:
        self.values.clear()
        self.values.update(state)


class Gauge(Instrument):
    kind = "gauge"

    def __init__(self, name: str):
        super().__init__(name)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def pack(self):
        return float(self.value)

    def unpack(self, state) -> None:
        self.value = float(state)


class IntHistogram(Instrument):
    """Exact integer-valued histogram (e.g. staleness tau -> count)."""

    kind = "int_histogram"

    def __init__(self, name: str):
        super().__init__(name)
        self.counts: _PyCounter = _PyCounter()

    def observe(self, value: int, n: int = 1) -> None:
        self.counts[int(value)] += n

    def quantile(self, q: float) -> Optional[float]:
        """Exact q-quantile (q in [0, 1]) of the observed integers: the
        smallest value whose cumulative count reaches q * total — i.e.
        `numpy.percentile(..., method="inverted_cdf")`, which the
        property tests pin. None when empty."""
        total = sum(self.counts.values())
        if total == 0:
            return None
        target = q * total
        cum = 0
        for k in sorted(self.counts):
            cum += self.counts[k]
            if cum >= target - 1e-9:
                return float(k)
        return float(max(self.counts))

    def pack(self):
        return {str(k): int(self.counts[k]) for k in sorted(self.counts)}

    def unpack(self, state) -> None:
        self.counts.clear()
        self.counts.update({int(k): int(v) for k, v in state.items()})


class Histogram(Instrument):
    """Fixed-bucket float histogram: bucket i counts x < edges[i], the
    last (overflow) bucket counts x >= edges[-1]. Also tracks sum/count
    so means survive the bucketing."""

    kind = "histogram"

    def __init__(self, name: str, edges: Sequence[float] = (0.001, 0.01,
                                                            0.1, 1.0, 10.0)):
        super().__init__(name)
        self.edges = [float(e) for e in edges]
        if self.edges != sorted(self.edges) or len(self.edges) < 1:
            raise ValueError(f"histogram edges must be sorted, got {edges}")
        self.buckets = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        # observed range: tightens the open-ended first/overflow buckets
        # in quantile(); process-local refinement, not part of pack()
        # (the checkpoint schema predates it and loses nothing material)
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float, n: int = 1) -> None:
        self.buckets[int(np.searchsorted(self.edges, x, side="right"))] += n
        self.sum += float(x) * n
        self.count += n
        x = float(x)
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (q in [0, 1]) by linear interpolation
        within the bucket holding the q*count-th observation — the
        standard `histogram_quantile` estimate, so the error is bounded
        by that bucket's width (the property tests pin this against
        `numpy.percentile`). Bucket bounds are clamped to the observed
        min/max where known. None when empty."""
        if self.count == 0:
            return None
        lo0 = self.min if math.isfinite(self.min) else self.edges[0]
        hi_last = self.max if math.isfinite(self.max) else self.edges[-1]
        bounds = ([(min(lo0, self.edges[0]), self.edges[0])]
                  + list(zip(self.edges[:-1], self.edges[1:]))
                  + [(self.edges[-1], max(hi_last, self.edges[-1]))])
        target = q * self.count
        cum = 0
        for b, (lo, hi) in zip(self.buckets, bounds):
            if b > 0 and cum + b >= target - 1e-9:
                lo = max(lo, lo0)
                hi = max(min(hi, hi_last), lo)
                frac = min(max((target - cum) / b, 0.0), 1.0)
                return float(lo + frac * (hi - lo))
            cum += b
        return float(hi_last)

    def pack(self):
        return {"edges": list(self.edges), "buckets": list(self.buckets),
                "sum": float(self.sum), "count": int(self.count)}

    def unpack(self, state) -> None:
        if [float(e) for e in state["edges"]] != self.edges:
            raise ValueError(f"histogram {self.name!r} edge mismatch: "
                             f"{state['edges']} vs {self.edges}")
        self.buckets = [int(b) for b in state["buckets"]]
        self.sum = float(state["sum"])
        self.count = int(state["count"])
        self.min = math.inf
        self.max = -math.inf

    def reset(self) -> None:
        self.buckets = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Reservoir(Instrument):
    """Bounded sample buffer for wall latencies: a `deque(maxlen=…)`, so
    long-running services keep the most recent window instead of growing
    without bound. `samples` is exposed raw (append/clear are the hot
    operations and a method call per observation would be pure tax)."""

    kind = "reservoir"

    def __init__(self, name: str, maxlen: int = 8192):
        super().__init__(name)
        self.samples: deque = deque(maxlen=int(maxlen))

    def observe(self, seconds: float) -> None:
        self.samples.append(float(seconds))

    def stats(self) -> Optional[Dict[str, float]]:
        return latency_stats(self.samples)

    def pack(self):
        return [float(s) for s in self.samples]

    def unpack(self, state) -> None:
        self.samples.clear()
        self.samples.extend(float(s) for s in state)

    def reset(self) -> None:
        self.samples.clear()


_KINDS = {c.kind: c for c in (Counter, CounterVec, Gauge, IntHistogram,
                              Histogram, Reservoir)}


class MetricsRegistry:
    """Name -> instrument map with get-or-create factories. Creating an
    existing name returns the existing instrument (and raises if the kind
    differs — two subsystems silently sharing one name with different
    semantics is the bug this catches)."""

    def __init__(self):
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, cls, name: str, *args, **kw):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(f"instrument {name!r} already registered "
                                 f"as {inst.kind}, not {cls.kind}")
            return inst
        inst = cls(name, *args, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def counter_vec(self, name: str) -> CounterVec:
        return self._get(CounterVec, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def int_histogram(self, name: str) -> IntHistogram:
        return self._get(IntHistogram, name)

    def histogram(self, name: str, edges=None) -> Histogram:
        return (self._get(Histogram, name) if edges is None
                else self._get(Histogram, name, edges))

    def reservoir(self, name: str, maxlen: int = 8192) -> Reservoir:
        return self._get(Reservoir, name, maxlen)

    # ------------------------------------------------------------------ #
    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __getitem__(self, name: str) -> Instrument:
        return self._instruments[name]

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def pack(self, names: Optional[Sequence[str]] = None) -> Dict:
        """Deterministic state of the named instruments (default: every
        non-reservoir — see module docstring), sorted-key JSON-native."""
        if names is None:
            names = [n for n, i in self._instruments.items()
                     if i.kind != "reservoir"]
        return {n: self._instruments[n].pack() for n in sorted(names)}

    def unpack(self, state: Dict) -> None:
        for name, sub in state.items():
            if name not in self._instruments:
                raise KeyError(f"unknown instrument {name!r} in state "
                               f"(known: {self.names()})")
            self._instruments[name].unpack(sub)

    def snapshot(self) -> Dict:
        """Debug view: every instrument's current state (reservoirs report
        stats, not raw samples)."""
        out = {}
        for n in sorted(self._instruments):
            inst = self._instruments[n]
            out[n] = (inst.stats() if isinstance(inst, Reservoir)
                      else inst.pack())
        return out
