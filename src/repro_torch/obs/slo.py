"""Declarative SLOs over a `MetricsRegistry` / `SimResult` (DESIGN.md
§16).

An `SLO` names a metric source, a statistic, and a threshold:

  SLO("dispatch_p99_ms", metric="service.dispatch_s", stat="p99",
      op="<=", threshold=250.0, objective=0.95, window=20)

`SLOSet` evaluates a list of them and keeps a rolling pass/fail window
per SLO, reporting multi-window *burn rate* the way Prometheus/SRE
alerting does: with objective q, an error budget of (1-q) checks per
window is allowed, and

  burn_rate = (breaches in window / window) / (1 - objective)

so burn 1.0 means the budget is being spent exactly as fast as allowed
("warn"), and >= 2.0 means it burns twice as fast ("breach"). Checks
where the metric has no data yet (empty reservoir, target never
evaluated) report status "no_data" and do not consume budget.

Metric sources:

  registry instruments   by name — Reservoir (stat p50/p95/p99/mean/max,
                         milliseconds), Histogram/IntHistogram (pXX via
                         their `quantile`, mean), Counter/Gauge (value),
                         CounterVec (stat "key:<name>")
  SimResult              "result.<attr>" (value), and
                         "records.straggling" — per-aggregation
                         straggling latency, seconds (stat pXX/mean/max)

`ParamService` evaluates its `SLOSet` inside `poll()` every
`slo_every` caller-clock seconds, surfaces each SLO as
`slo.<name>.{value,burn_rate,ok}` gauges on its registry, and logs a
structured event on every status transition — the scrape/alert surface
`repro_torch.obs.export.prometheus_text` then exposes.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

#: burn-rate boundaries: < WARN_AT is "ok", < BREACH_AT is "warn"
WARN_AT = 1.0
BREACH_AT = 2.0


@dataclass(frozen=True)
class SLO:
    name: str
    metric: str
    stat: str = "value"        # value | mean | max | pXX | key:<name>
    op: str = "<="             # "<=" or ">="
    threshold: float = 0.0
    objective: float = 0.95    # fraction of checks that must pass
    window: int = 20           # rolling check window for the burn rate
    description: str = ""

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"SLO op must be <= or >=, got {self.op!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO objective must be in (0, 1), "
                             f"got {self.objective}")

    def met(self, value: float) -> bool:
        return (value <= self.threshold if self.op == "<="
                else value >= self.threshold)


def _stat_of_samples(samples, stat: str, scale: float = 1.0,
                     ) -> Optional[float]:
    vals = np.asarray(list(samples), dtype=np.float64) * scale
    if vals.size == 0:
        return None
    if stat.startswith("p") and stat[1:].replace(".", "", 1).isdigit():
        return float(np.percentile(vals, float(stat[1:])))
    if stat == "mean":
        return float(vals.mean())
    if stat == "max":
        return float(vals.max())
    raise ValueError(f"unknown sample stat {stat!r}")


def _measure_registry(slo: SLO, registry) -> Optional[float]:
    if slo.metric not in registry:
        return None
    inst = registry[slo.metric]
    kind = inst.kind
    if kind == "reservoir":            # wall seconds -> milliseconds
        return _stat_of_samples(inst.samples, slo.stat, scale=1e3)
    if kind in ("histogram", "int_histogram"):
        if slo.stat.startswith("p"):
            return inst.quantile(float(slo.stat[1:]) / 100.0)
        if slo.stat == "mean":
            n = getattr(inst, "count", None)
            if n is None:              # IntHistogram
                n = sum(inst.counts.values())
                return (sum(k * v for k, v in inst.counts.items()) / n
                        if n else None)
            return inst.sum / n if n else None
        raise ValueError(f"unknown histogram stat {slo.stat!r}")
    if kind == "counter_vec":
        if not slo.stat.startswith("key:"):
            raise ValueError(f"CounterVec SLO needs stat 'key:<name>', "
                             f"got {slo.stat!r}")
        return float(inst.values.get(slo.stat[4:], 0))
    return float(inst.value)           # counter / gauge


def _measure_result(slo: SLO, result) -> Optional[float]:
    if slo.metric == "records.straggling":
        return _stat_of_samples(
            [r.straggling for r in result.records if r.n_updates > 0],
            slo.stat)
    if slo.metric.startswith("result."):
        v = getattr(result, slo.metric[len("result."):])
        return None if v is None else float(v)
    return None


class SLOSet:
    """A list of SLOs plus their rolling check state; see module
    docstring. `evaluate()` returns one row per SLO and is safe to call
    with either or both sources."""

    def __init__(self, slos: Sequence[SLO]):
        self.slos: List[SLO] = list(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self._window: Dict[str, deque] = {
            s.name: deque(maxlen=s.window) for s in self.slos}
        self._checks: Dict[str, int] = {s.name: 0 for s in self.slos}
        self._breaches: Dict[str, int] = {s.name: 0 for s in self.slos}
        self._last: Dict[str, Dict] = {}

    def evaluate(self, registry=None, result=None) -> List[Dict]:
        rows = []
        for slo in self.slos:
            value = None
            if registry is not None:
                value = _measure_registry(slo, registry)
            if value is None and result is not None:
                value = _measure_result(slo, result)
            rows.append(self._check(slo, value))
        return rows

    def _check(self, slo: SLO, value: Optional[float]) -> Dict:
        win = self._window[slo.name]
        row = {"name": slo.name, "metric": slo.metric, "stat": slo.stat,
               "op": slo.op, "threshold": slo.threshold,
               "objective": slo.objective,
               "description": slo.description}
        if value is None:
            row.update(value=None, met=None, status="no_data",
                       burn_rate=0.0, checks=self._checks[slo.name],
                       breaches=self._breaches[slo.name])
            self._last[slo.name] = row
            return row
        met = slo.met(value)
        win.append(met)
        self._checks[slo.name] += 1
        self._breaches[slo.name] += (not met)
        # budget over the *full* window: unfilled slots count as passes,
        # so one early breach cannot instantly page
        frac = sum(1 for ok in win if not ok) / slo.window
        burn = frac / (1.0 - slo.objective)
        status = ("ok" if burn < WARN_AT
                  else "warn" if burn < BREACH_AT else "breach")
        row.update(value=round(float(value), 6), met=met, status=status,
                   burn_rate=round(burn, 4), checks=self._checks[slo.name],
                   breaches=self._breaches[slo.name])
        self._last[slo.name] = row
        return row

    def report(self) -> List[Dict]:
        """Last evaluation row per SLO (declaration order)."""
        return [dict(self._last.get(s.name,
                                    {"name": s.name, "status": "no_data",
                                     "value": None, "burn_rate": 0.0,
                                     "threshold": s.threshold,
                                     "checks": 0, "breaches": 0}))
                for s in self.slos]

    def worst_status(self) -> str:
        order = {"no_data": 0, "ok": 1, "warn": 2, "breach": 3}
        worst = "no_data"
        for row in self.report():
            if order[row["status"]] > order[worst]:
                worst = row["status"]
        return worst


# --------------------------------------------------------------------- #
# default objective sets
# --------------------------------------------------------------------- #
def default_service_slos(dispatch_p99_ms: float = 250.0,
                         submit_p99_ms: float = 400.0,
                         staleness_p95: float = 8.0) -> SLOSet:
    """The serving-surface SLOs `ParamService` evaluates in poll():
    wall-clock dispatch/submit p99 (the host-side cost a real transport
    would sit on top of) and the staleness p95 of applied updates (how
    far behind the globals the stream is allowed to run)."""
    return SLOSet([
        SLO("dispatch_p99_ms", "service.dispatch_s", "p99", "<=",
            dispatch_p99_ms, objective=0.9, window=20,
            description="wall-clock dispatch processing p99"),
        SLO("submit_p99_ms", "service.submit_s", "p99", "<=",
            submit_p99_ms, objective=0.9, window=20,
            description="wall-clock submit (codec round trip) p99"),
        SLO("staleness_p95", "service.staleness", "p95", "<=",
            staleness_p95, objective=0.95, window=20,
            description="staleness tau p95 of applied updates"),
    ])


def default_sim_slos(straggling_p95: float = 60.0,
                     time_to_target: Optional[float] = None) -> SLOSet:
    """Simulation SLOs evaluated against a finished `SimResult`: the
    per-aggregation straggling-latency spread (the paper's headline
    metric) and, when a target accuracy was set, virtual time to reach
    it."""
    slos = [SLO("straggling_p95", "records.straggling", "p95", "<=",
                straggling_p95, objective=0.9, window=10,
                description="per-aggregation straggling latency p95 (s)")]
    if time_to_target is not None:
        slos.append(SLO("time_to_target_s", "result.time_to_target",
                        "value", "<=", time_to_target, objective=0.9,
                        window=5,
                        description="virtual seconds to target accuracy"))
    return SLOSet(slos)
