"""Dual-clock span tracer with Chrome trace-event export (DESIGN.md §16).

One process-wide tracer records *spans* (named intervals), *instants*
(point events) and *counters* (named time series) against two independent
clocks:

  wall     — ``time.perf_counter`` relative to tracer start; where the
             server/service actually spends host time (PPO forward, codec
             round trip, jit dispatch, checkpoint IO).
  virtual  — the simulator/service caller-owned clock (`EventScheduler.t`,
             the `now` passed to `ParamService` entry points); where the
             *simulated* round time goes (assess, local training, links,
             wave barriers).

Virtual-clock events carry no wall timestamps at all, so two bit-identical
simulation runs produce bit-identical virtual event streams — the tracer
determinism pin in tests/test_obs.py relies on this.

Tracing is off by default: the module-level singleton is a `NullTracer`
whose `enabled` attribute is False and whose methods are allocation-free
no-ops returning one shared null context manager. Instrumented hot paths
either guard with ``if tr.enabled:`` (the per-event scheduler loop — one
attribute lookup when disabled) or just enter the null span (wave-level
callbacks, a few calls per round). `enable()` swaps in a real `Tracer`;
`disable()` swaps the singleton back.

`export()` writes Chrome trace-event JSON ("JSON Array Format" with a
`traceEvents` wrapper) loadable in Perfetto (https://ui.perfetto.dev):
the two clocks render as two *process* tracks ("wall clock" pid 1,
"virtual clock" pid 2), named threads within each, "X" complete events
for spans (Perfetto nests by containment), "i" instants and "C" counters.
`validate_chrome_trace` checks the invariants the exporter guarantees
(required keys, non-negative durations, monotone `ts` per track) and is
what the ``--only obs`` bench smoke asserts.

Phase spans (`phase`) time the port's hot path: the train step and its
parts, each MoE layer, the serve engine's prefill, graph replays and
calls. A phase takes a host interval on `time.perf_counter` and, once CUDA
is initialised, a pair of timing events on the current stream, drawn from
a pool; it never synchronises, and its device interval is resolved only
when spans are read (`profiled`) or exported. It records

  - while a `Tracer` is enabled (the operator's switch): a wall span on
    the "torch" thread, a `record_function` range for any running
    profiler, and at export the device interval on a track of its own
    (pid 3), aligned to the wall clock by an event recorded after a
    synchronise when the tracer started;
  - while a `torch.profiler` session runs (torch's own Python-side
    flag): into a bounded process-wide buffer read by `profiled()`, with
    no `record_function` range, so the profile's device timeline holds
    only device work.

Otherwise, and while the current stream is being captured into a CUDA
graph, `phase` returns the shared null span.
"""
from __future__ import annotations

import collections
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

WALL = "wall"
VIRTUAL = "virtual"
DEVICE = "device"
_PID = {WALL: 1, VIRTUAL: 2, DEVICE: 3}
_PROCESS_NAMES = {1: "wall clock", 2: "virtual clock (sim)",
                  3: "device clock (CUDA events)"}


class _NullSpan:
    """Shared reusable no-op context manager."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a cheap no-op. Instrumented code
    holds `current()` and checks `.enabled` (one attribute lookup) on the
    hottest paths; elsewhere it just enters the shared null span."""

    enabled = False

    def span(self, name, clock=WALL, tid="main", **args):
        return _NULL_SPAN

    def span_at(self, name, begin, end, clock=VIRTUAL, tid="main", **args):
        return None

    def instant(self, name, clock=WALL, tid="main", t=None, **args):
        return None

    def counter(self, name, values, clock=WALL, tid=None, t=None):
        return None

    def set_virtual(self, t):
        return None


NULL_TRACER = NullTracer()


class _Span:
    """Live wall/virtual span: records begin time on enter, appends one
    "X" complete event on exit."""

    __slots__ = ("tracer", "name", "clock", "tid", "args", "_t0")

    def __init__(self, tracer, name, clock, tid, args):
        self.tracer = tracer
        self.name = name
        self.clock = clock
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = self.tracer._now(self.clock)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        tr._push(self.name, "X", self.clock, self.tid, self._t0,
                 tr._now(self.clock) - self._t0, self.args)
        return False


class Tracer:
    """Enabled tracer; see module docstring. Events are stored as small
    dicts with timestamps in *seconds* on their own clock and converted to
    Chrome's microseconds only at export."""

    enabled = True

    def __init__(self):
        self._vnow = 0.0
        self.events: List[Dict] = []
        self.phases: List["_Phase"] = []
        self._start()

    def _start(self) -> None:
        """Zero the wall clock; on a card, record the device reference event
        after a synchronise, so that it completes at the wall time read
        just after it."""
        self._ref = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self._ref = ev
        self._wall0 = time.perf_counter()
        self._epoch0_ns = time.time_ns()

    # ------------------------------------------------------------------ #
    def _now(self, clock: str) -> float:
        if clock == WALL:
            return time.perf_counter() - self._wall0
        return self._vnow

    def set_virtual(self, t: float) -> None:
        """Advance the virtual clock (the scheduler's `self.t` / the
        service's caller-owned `now`)."""
        self._vnow = float(t)

    def _push(self, name, ph, clock, tid, ts, dur, args) -> Dict:
        ev = {"name": name, "ph": ph, "clock": clock, "tid": tid,
              "ts": float(ts)}
        if dur is not None:
            ev["dur"] = float(dur)
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------------ #
    def span(self, name, clock=WALL, tid="main", **args):
        """Context manager measuring a live interval on `clock`."""
        return _Span(self, name, clock, tid, args)

    def span_at(self, name, begin, end, clock=VIRTUAL, tid="main", **args):
        """Record a span with explicit begin/end times (how virtual-clock
        intervals are emitted retrospectively, e.g. at wave resolution).
        Returns the stored event dict."""
        return self._push(name, "X", clock, tid, float(begin),
                          max(float(end) - float(begin), 0.0), args)

    def instant(self, name, clock=WALL, tid="main", t=None, **args):
        ts = self._now(clock) if t is None else float(t)
        return self._push(name, "i", clock, tid, ts, None, args)

    def counter(self, name, values, clock=WALL, tid=None, t=None):
        """One sample of a counter time series. `values` is a number or a
        {series: number} dict (rendered stacked in Perfetto)."""
        if not isinstance(values, dict):
            values = {"value": values}
        vals = {k: float(v) for k, v in values.items()
                if isinstance(v, (int, float)) and v == v}  # drop None/NaN
        if not vals:
            return None
        ts = self._now(clock) if t is None else float(t)
        return self._push(name, "C", clock, tid or name, ts, None, vals)

    def _add_phase(self, p: "_Phase") -> None:
        """A closed phase: its host interval as a wall span on the "torch"
        thread now, its device interval at export."""
        self._push(p.name, "X", WALL, "torch", p.t0 - self._wall0,
                   p.t1 - p.t0, p.args)
        self.phases.append(p)

    def _device_rows(self) -> List[Dict]:
        """The phases' device intervals as "X" events on the device clock,
        in seconds from the wall clock's zero: the reference event's offset
        to each phase's root start, plus the phase's offset in its root."""
        if self._ref is None:
            return []
        rows, at = [], {}
        for p in self.phases:
            r = resolve(p)
            if r["device"] is None:
                continue
            base = p.root if p.root.e0 is not None else p
            if base.seq not in at:
                try:
                    at[base.seq] = self._ref.elapsed_time(base.e0) / 1e3
                except RuntimeError:   # recorded on another device
                    at[base.seq] = None
            if at[base.seq] is None:
                continue
            d0, d1 = r["device"]
            rows.append({"name": p.name, "ph": "X", "clock": DEVICE,
                         "tid": "cuda", "ts": at[base.seq] + d0 / 1e3,
                         "dur": max(d1 - d0, 0.0) / 1e3,
                         **({"args": p.args} if p.args else {})})
        return rows

    # ------------------------------------------------------------------ #
    def virtual_records(self) -> List:
        """Canonical, deterministic view of the virtual-clock events:
        sorted tuples carrying no wall-clock state. Two identical sim runs
        compare equal on this (pinned in tests/test_obs.py)."""
        out = []
        for ev in self.events:
            if ev["clock"] != VIRTUAL:
                continue
            args = tuple(sorted((k, v) for k, v in ev.get("args", {}).items()
                                if isinstance(v, (int, float, str))))
            out.append((round(ev["ts"], 9), round(ev.get("dur", 0.0), 9),
                        ev["ph"], ev["name"], str(ev["tid"]), args))
        return sorted(out)

    def clear(self) -> None:
        self.events.clear()
        self.phases.clear()
        self._vnow = 0.0
        self._start()

    # ------------------------------------------------------------------ #
    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON object (see module docstring)."""
        tids: Dict = {}          # (pid, tid name) -> int tid
        meta: List[Dict] = []
        for pid, pname in _PROCESS_NAMES.items():
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": pname}})

        def tid_of(pid, name):
            key = (pid, str(name))
            if key not in tids:
                tids[key] = len(tids) + 1
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tids[key], "args": {"name": str(name)}})
            return tids[key]

        rows = []
        for ev in self.events + self._device_rows():
            pid = _PID[ev["clock"]]
            row = {"name": ev["name"], "ph": ev["ph"], "pid": pid,
                   "tid": tid_of(pid, ev["tid"]),
                   "ts": round(ev["ts"] * 1e6, 3)}
            if ev["ph"] == "X":
                row["dur"] = round(ev.get("dur", 0.0) * 1e6, 3)
            if ev["ph"] == "i":
                row["s"] = "t"           # thread-scoped instant
            if "args" in ev:
                row["args"] = ev["args"]
            rows.append(row)
        # monotone ts per track by construction: one global stable sort
        rows.sort(key=lambda r: (r["ts"], r["pid"], r["tid"]))
        # torch.profiler's host events are on the epoch clock: ts 0 here is
        # this epoch time
        return {"traceEvents": meta + rows, "displayTimeUnit": "ms",
                "otherData": {"epoch_ns_at_ts0": self._epoch0_ns}}

    def export(self, path) -> Path:
        """Write the Chrome trace JSON; open it at https://ui.perfetto.dev."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), sort_keys=True))
        return path


# --------------------------------------------------------------------- #
# process-wide singleton
# --------------------------------------------------------------------- #
_current = NULL_TRACER
_tracing = False            # _current is a Tracer: phases record


def current():
    """The process-wide tracer (a `NullTracer` unless `enable()` ran)."""
    return _current


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process-wide tracer. Idempotent when one
    is already active and no explicit tracer is given."""
    global _current, _tracing
    if tracer is None:
        if isinstance(_current, Tracer):
            return _current
        tracer = Tracer()
    _current, _tracing = tracer, True
    return tracer


def disable():
    """Swap the no-op singleton back in (recorded events are dropped with
    the old tracer unless the caller kept a reference)."""
    global _current, _tracing
    _current, _tracing = NULL_TRACER, False


# --------------------------------------------------------------------- #
# phase spans (module docstring)
# --------------------------------------------------------------------- #
#: the most phases `profiled()` keeps; the oldest go first
PROFILED_MAX = 4096
_profiled: collections.deque = collections.deque(maxlen=PROFILED_MAX)
_pool: Dict[int, List] = {}     # device index -> free timing events
_open: List["_Phase"] = []      # the open recording phases, outermost first
_seq = 0                        # phases entered so far


def _take_event(dev: int):
    free = _pool.get(dev)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Phase:
    """A recording phase span (see `phase`). Closed, it is the record that
    `resolve` reads: its root is the outermost phase open when it started
    (itself if none was)."""

    __slots__ = ("name", "args", "seq", "root", "depth", "t0", "t1", "dev",
                 "e0", "e1", "_tracer", "_profiled", "_range", "_out")
    recording = True

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self._out = None

    def __enter__(self):
        global _seq
        self._tracer = _current if _tracing else None
        self._profiled = _torch_profiler._is_profiler_enabled
        self.seq = _seq
        _seq += 1
        self.root = _open[0] if _open else self
        self.depth = len(_open)
        _open.append(self)
        self._range = None
        if self._tracer is not None:
            self._range = _torch_profiler.record_function(self.name)
            self._range.__enter__()
        self.e0 = self.e1 = None
        if torch.cuda.is_initialized():
            self.dev = torch.cuda.current_device()
            self.e0 = _take_event(self.dev)
            self.e0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.e0 is not None:
            self.e1 = _take_event(self.dev)
            self.e1.record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if _open and _open[-1] is self:
            _open.pop()
        if self._profiled:
            _profiled.append(self)
        if self._tracer is not None:
            self._tracer._add_phase(self)
            self._tracer = None
        return False


def phase(name: str, **args):
    """A phase span named `name` (args ride on its record), or the shared
    null span where nothing records it: no tracer enabled and no
    torch.profiler session running, or the current stream capturing a CUDA
    graph. Nothing in it synchronises with the card."""
    if not (_tracing or _torch_profiler._is_profiler_enabled):
        return _NULL_SPAN
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        return _NULL_SPAN
    return _Phase(name, args)


def resolve(p: _Phase) -> Dict:
    """A closed phase's record: name, seq (entry order), root (its root's
    seq), depth, host (start, end) on `time.perf_counter` in seconds,
    device (start, end) in ms from its root's start event (from its own
    where the root has none), or None off CUDA, and args. Waits for the
    phase's end event on first read; then its events go back to the pool
    (a root's start event, which its children are read against, does
    not)."""
    if p._out is not None:
        return p._out
    dev = None
    if p.e1 is not None:
        p.e1.synchronize()
        base = p.root if p.root.e0 is not None else p
        d0 = 0.0 if base is p else base.e0.elapsed_time(p.e0)
        dev = (d0, base.e0.elapsed_time(p.e1))
        free = _pool.setdefault(p.dev, [])
        free.append(p.e1)
        p.e1 = None
        if base is not p:
            free.append(p.e0)
            p.e0 = None
    p._out = {"name": p.name, "seq": p.seq, "root": p.root.seq,
              "depth": p.depth, "host": (p.t0, p.t1), "device": dev,
              "args": dict(p.args)}
    return p._out


def profiled(clear: bool = False) -> List[Dict]:
    """The phases closed while a torch.profiler session ran (at most
    `PROFILED_MAX`, the newest), resolved (`resolve`) in entry order;
    `clear` empties the buffer after reading it."""
    out = [resolve(p) for p in sorted(_profiled, key=lambda q: q.seq)]
    if clear:
        _profiled.clear()
    return out


# --------------------------------------------------------------------- #
# validation + summaries
# --------------------------------------------------------------------- #
REQUIRED_KEYS = ("name", "ph", "pid", "tid", "ts")


def validate_chrome_trace(trace: Dict) -> Dict:
    """Assert the Chrome trace-event invariants the exporter guarantees:
    a `traceEvents` list, required keys on every event, non-negative
    durations on "X" events, non-decreasing `ts` within each (pid, tid)
    track, and well-formed counters — every "C" sample must carry a
    non-empty numeric args dict with *finite* values (NaN/inf silently
    break Perfetto's counter rendering), non-decreasing in `ts` per
    (pid, name) counter track (counters with the same name form one
    Perfetto track regardless of tid, so a merged trace can violate this
    while every (pid, tid) track stays monotone). Returns summary stats;
    raises ValueError on any violation (the ``--only obs`` bench smoke
    calls this)."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    last_ts: Dict = {}
    last_counter_ts: Dict = {}
    stats = {"n_events": 0, "n_spans": 0, "n_counters": 0, "n_instants": 0,
             "tracks": set(), "pids": set()}
    for i, ev in enumerate(events):
        if ev.get("ph") == "M":
            continue
        for k in REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing key {k!r}: {ev}")
        track = (ev["pid"], ev["tid"])
        if ev["ts"] < last_ts.get(track, float("-inf")):
            raise ValueError(f"event {i} breaks ts monotonicity on track "
                             f"{track}: {ev['ts']} < {last_ts[track]}")
        last_ts[track] = ev["ts"]
        if ev["ph"] == "X":
            if ev.get("dur", -1.0) < 0.0:
                raise ValueError(f"X event {i} has negative/missing dur")
            stats["n_spans"] += 1
        elif ev["ph"] == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(f"counter event {i} ({ev['name']!r}) has "
                                 f"no args series")
            for series, v in args.items():
                if (isinstance(v, bool)
                        or not isinstance(v, (int, float))
                        or not math.isfinite(v)):
                    raise ValueError(
                        f"counter event {i} ({ev['name']!r}) series "
                        f"{series!r} has non-finite value {v!r}")
            ctrack = (ev["pid"], ev["name"])
            if ev["ts"] < last_counter_ts.get(ctrack, float("-inf")):
                raise ValueError(
                    f"counter event {i} breaks ts monotonicity on counter "
                    f"track {ctrack}: {ev['ts']} < "
                    f"{last_counter_ts[ctrack]}")
            last_counter_ts[ctrack] = ev["ts"]
            stats["n_counters"] += 1
        elif ev["ph"] == "i":
            stats["n_instants"] += 1
        stats["n_events"] += 1
        stats["tracks"].add(track)
        stats["pids"].add(ev["pid"])
    stats["tracks"] = sorted(stats["tracks"])
    stats["pids"] = sorted(stats["pids"])
    return stats


#: per-wave virtual-time components recorded on wave-barrier spans
WAVE_PHASES = ("assess", "local", "comm", "barrier")


def wave_timing_summary(wave_spans: List[Dict]) -> Optional[Dict]:
    """Aggregate the per-wave virtual-time breakdown carried on the wave
    barrier span args (assess/local/comm/barrier seconds) into the
    `SimResult.timing` summary: per-phase mean/max/total over waves."""
    rows = [ev.get("args", {}) for ev in wave_spans if ev]
    rows = [a for a in rows if all(p in a for p in WAVE_PHASES)]
    if not rows:
        return None
    out: Dict = {"n_waves": len(rows)}
    for p in WAVE_PHASES:
        vals = [float(a[p]) for a in rows]
        out[p] = {"mean": round(sum(vals) / len(vals), 6),
                  "max": round(max(vals), 6),
                  "total": round(sum(vals), 6)}
    return out
