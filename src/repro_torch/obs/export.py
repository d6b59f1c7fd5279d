"""Scrape/tail surfaces for a `MetricsRegistry` (DESIGN.md §16).

`prometheus_text` renders any registry in the Prometheus text exposition
format (version 0.0.4) with fully deterministic output for identical
state: families in sorted metric-name order, label sets in sorted key
order, numbers via repr so they round-trip through `float()` exactly.
Instrument mapping:

  Counter       <ns>_<name>_total
  CounterVec    <ns>_<name>_total{key="…"}       (one sample per key)
  Gauge         <ns>_<name>
  IntHistogram  histogram with one le="k" bucket per observed integer
  Histogram     histogram over the configured edges (our buckets count
                x < edge; Prometheus `le` is x <= edge — identical
                unless an observation lands exactly on an edge)
  Reservoir     summary with quantile="0.5/0.9/0.99" + _sum/_count
                (wall seconds; omitted-when-empty except _count/_sum)

`parse_prometheus_text` is the minimal inverse used by the round-trip
parity tests. `JsonlEventLog` is the append-only structured event
stream: one sorted-key JSON object per line with size-based rotation
(`path` -> `path.1` -> … -> dropped), which `ServiceMetrics.log` tees
into when attached.
"""
from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

#: summary quantiles exposed for reservoirs
RESERVOIR_QUANTILES = (0.5, 0.9, 0.99)


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _fmt(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(d: Dict[str, str]) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{_escape(str(d[k]))}"' for k in sorted(d))
    return "{" + inner + "}"


def prometheus_text(registry, namespace: str = "hapfl",
                    const_labels: Optional[Dict[str, str]] = None) -> str:
    """Render the registry in the Prometheus text exposition format; see
    module docstring for the instrument mapping and determinism rules."""
    base_labels = dict(const_labels or {})
    lines = []

    def sample(name, labels, value):
        lines.append(f"{name}{_labels({**base_labels, **labels})} "
                     f"{_fmt(value)}")

    for name in registry.names():
        inst = registry[name]
        kind = inst.kind
        full = (f"{_sanitize(namespace)}_{_sanitize(name)}" if namespace
                else _sanitize(name))
        if kind == "counter":
            lines.append(f"# TYPE {full}_total counter")
            sample(f"{full}_total", {}, inst.value)
        elif kind == "counter_vec":
            lines.append(f"# TYPE {full}_total counter")
            for key in sorted(inst.values):
                sample(f"{full}_total", {"key": key}, inst.values[key])
        elif kind == "gauge":
            lines.append(f"# TYPE {full} gauge")
            sample(full, {}, inst.value)
        elif kind == "int_histogram":
            lines.append(f"# TYPE {full} histogram")
            cum, total = 0, sum(inst.counts.values())
            for k in sorted(inst.counts):
                cum += inst.counts[k]
                sample(f"{full}_bucket", {"le": _fmt(float(k))}, cum)
            sample(f"{full}_bucket", {"le": "+Inf"}, total)
            sample(f"{full}_sum", {},
                   float(sum(k * v for k, v in inst.counts.items())))
            sample(f"{full}_count", {}, total)
        elif kind == "histogram":
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for i, edge in enumerate(inst.edges):
                cum += inst.buckets[i]
                sample(f"{full}_bucket", {"le": _fmt(edge)}, cum)
            sample(f"{full}_bucket", {"le": "+Inf"}, inst.count)
            sample(f"{full}_sum", {}, inst.sum)
            sample(f"{full}_count", {}, inst.count)
        elif kind == "reservoir":
            lines.append(f"# TYPE {full} summary")
            vals = np.asarray(list(inst.samples), dtype=np.float64)
            if vals.size:
                for q in RESERVOIR_QUANTILES:
                    sample(full, {"quantile": _fmt(q)},
                           float(np.percentile(vals, 100.0 * q)))
            sample(f"{full}_sum", {}, float(vals.sum()) if vals.size else 0.0)
            sample(f"{full}_count", {}, int(vals.size))
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str,
                          ) -> Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                              float]]:
    """Minimal exposition-format parser (the inverse of
    `prometheus_text`, for round-trip tests): metric name -> {sorted
    label tuple -> value}."""
    out: Dict[str, Dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: "
                             f"{line!r}")
        name, rawlabels, value = m.groups()
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\n", "\n")
             .replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(rawlabels or "")))
        out.setdefault(name, {})[labels] = float(value)
    return out


def write_prometheus(registry, path, namespace: str = "hapfl",
                     const_labels: Optional[Dict[str, str]] = None) -> Path:
    """Write one exposition snapshot (node-exporter textfile style)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prometheus_text(registry, namespace=namespace,
                                    const_labels=const_labels))
    return path


class JsonlEventLog:
    """Append-only JSONL event stream with size-based rotation: events
    land in `path`; when the file would exceed `max_bytes` it is rotated
    to `path.1` (existing `path.N` shift up, the oldest beyond
    `max_files` is deleted). Lines are sorted-key compact JSON, so a
    byte-identical event stream produces byte-identical files."""

    def __init__(self, path, max_bytes: int = 4_000_000,
                 max_files: int = 3):
        if max_bytes <= 0 or max_files < 1:
            raise ValueError("max_bytes must be > 0 and max_files >= 1")
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self.n_written = 0
        self.n_rotations = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._size = self.path.stat().st_size

    def write(self, event: Dict) -> None:
        line = json.dumps(event, sort_keys=True,
                          separators=(",", ":")) + "\n"
        if self._size > 0 and self._size + len(line) > self.max_bytes:
            self._rotate()
        self._f.write(line)
        self._size += len(line)
        self.n_written += 1

    def _rotate(self) -> None:
        self._f.close()
        oldest = self.path.with_name(f"{self.path.name}.{self.max_files}")
        if oldest.exists():
            os.remove(oldest)
        for i in range(self.max_files - 1, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                os.replace(src, self.path.with_name(
                    f"{self.path.name}.{i + 1}"))
        os.replace(self.path, self.path.with_name(f"{self.path.name}.1"))
        self._f = open(self.path, "a")
        self._size = 0
        self.n_rotations += 1

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
