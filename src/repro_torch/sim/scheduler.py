"""Virtual-clock discrete-event FL scheduler (DESIGN.md §10).

The scheduler owns the virtual clock and the event queue; the HAPFL server
owns the learning machinery. A *wave* is one dispatched cohort: at dispatch
the server plans it (selection -> assessment -> PPO1 sizes -> PPO2
intensities) and trains it for real from the current globals — grouped
into per-size cohorts by the batched engine — while the scheduler turns
the simulated per-client times into future events:

    dispatch --(download + assess)--> ASSESS_DONE
             --(+ local training + upload)--> ARRIVAL
    availability trace off-transition before arrival -> DROPOUT (+ REJOIN)
    deadline policy -> one DEADLINE event per wave

The aggregation policy decides what happens on ARRIVAL (see
repro_torch.sim.policies). Under `sync` the event path reduces to the
legacy barrier round and reproduces `HAPFLServer.run` byte-for-byte — the
parity test in tests/test_torch_sim.py pins this. Under `buffered`/`async`
the server's in-flight population is topped up after every aggregation, so
fast clients keep contributing while stragglers compute; their late updates
carry staleness tau = aggregations-since-dispatch and are discounted by
(1+tau)^-a. The staleness tags are policy-level metadata handed to
`HAPFLServer.apply_updates`, so they reach whichever aggregation mode the
server runs — per-size-group or cross-size nested (DESIGN.md §12) — without
the scheduler knowing which.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.latency import (AvailabilityModel, CommModel,
                                      straggling_latency)
from repro_torch.obs.trace import (VIRTUAL, current as _tracer,
                                   wave_timing_summary)
from repro_torch.sim.events import (ARRIVAL, ASSESS_DONE, DEADLINE,
                                    DROPOUT, REJOIN, Event, EventQueue)
from repro_torch.sim.policies import SyncPolicy


@dataclass
class AggRecord:
    """One server aggregation: what was folded in, and when."""
    time: float
    version: int
    n_updates: int
    staleness: Tuple[int, ...]
    straggling: float
    acc_lite: float = float("nan")


@dataclass
class SimResult:
    policy: str
    sim_time: float
    n_waves: int
    n_aggregations: int
    n_updates: int
    n_dropped: int
    n_assessed: int
    n_events: int
    mean_straggling: float
    final_acc: float
    time_to_target: Optional[float]
    up_bytes: float = 0.0          # wire bytes of updates that arrived
    down_bytes: float = 0.0        # wire bytes of dispatched broadcasts
    acc_curve: List[Tuple[float, float]] = field(default_factory=list)
    records: List[AggRecord] = field(default_factory=list)
    #: per-wave virtual-time breakdown (assess/local/comm/barrier seconds,
    #: mean/max/total over waves) from the trace's wave-barrier spans —
    #: populated only when tracing was enabled for the run, None otherwise
    timing: Optional[Dict] = None
    #: FleetHealth.summary() — straggler phase attribution, EWMA drift,
    #: per-size-group percentiles, churn (repro_torch.obs.health); populated
    #: only when a FleetHealth was attached to the run, None otherwise
    health: Optional[Dict] = None

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "sim_time": round(float(self.sim_time), 3),
            "n_waves": self.n_waves,
            "n_aggregations": self.n_aggregations,
            "n_updates": self.n_updates,
            "n_dropped": self.n_dropped,
            "n_assessed": self.n_assessed,
            "n_events": self.n_events,
            "mean_straggling": round(self.mean_straggling, 4),
            "final_acc": round(self.final_acc, 4),
            "time_to_target": (None if self.time_to_target is None
                               else round(self.time_to_target, 3)),
            "up_bytes": round(self.up_bytes, 1),
            "down_bytes": round(self.down_bytes, 1),
        }


class EventScheduler:
    """Drives a HAPFLServer's wave callbacks through virtual-clock events.

    comm=None means zero-cost links (the legacy model); availability=None
    means every client is always online. Both default off so `sync` parity
    with `HAPFLServer.run` holds exactly.
    """

    def __init__(self, server, policy, comm: Optional[CommModel] = None,
                 availability: Optional[AvailabilityModel] = None,
                 latency_only: bool = False, eval_accuracy: bool = True,
                 eval_every: int = 1, deterministic: bool = False,
                 participation: str = "full", health=None):
        if participation not in ("full", "sampled"):
            raise ValueError(f"unknown participation {participation!r}")
        self.server = server
        self.env = server.env
        self.policy = policy
        self.comm = comm
        self.availability = availability
        self.latency_only = latency_only
        self.eval_accuracy = eval_accuracy
        self.eval_every = max(int(eval_every), 1)
        self.deterministic = deterministic
        # struct-of-arrays client state (DESIGN.md §15): in-flight marks
        # mirror into it, and candidate filtering reads its mask instead
        # of probing a dict per client. participation="sampled" replaces
        # the O(n) full-population candidate scan with O(k) rejection
        # sampling over the store — the population-scale dispatch path
        # (different rng consumption than "full", so it is opt-in).
        self.store = getattr(server, "store", None)
        self.participation = participation
        if participation == "sampled" and self.store is None:
            raise ValueError("participation='sampled' needs a server with "
                             "a ClientStore (client_store=True)")

        self.t = 0.0
        self.version = 0               # server aggregation count
        self.queue = EventQueue()
        self.inflight: Dict[int, Tuple[int, int]] = {}  # client -> (wave, i)
        self.buffer: List[Tuple[int, int, float]] = []  # (wave, i, t_arrive)
        self.records: List[AggRecord] = []
        self.acc_curve: List[Tuple[float, float]] = []
        self.time_to_target: Optional[float] = None
        self.n_updates = 0
        self.n_dropped = 0
        self.n_assessed = 0
        self.n_events = 0              # events popped (throughput metric)
        self.up_bytes = 0.0            # counted at ARRIVAL: bytes that made it
        self.down_bytes = 0.0          # counted at dispatch: broadcast bytes
        self._waves: Dict[int, Dict] = {}
        self._wave_count = 0
        self._open_waves = 0
        self._max_waves = 0
        self._target: Optional[float] = None
        # observability (DESIGN.md §16): tracer handle cached here and
        # refreshed at run() so the per-event loop pays one attribute
        # lookup when tracing is off; wave-barrier span events (this
        # scheduler's own, not any other run's) feed SimResult.timing
        self._tr = _tracer()
        self._wave_spans: List[Dict] = []
        # fleet health analytics (repro_torch.obs.health): health=True
        # builds a default tracker; like tracing, attaching one is
        # observational — health=None runs stay byte-identical to
        # uninstrumented ones (pinned in tests/test_torch_sim.py). With
        # health on, the server also collects per-wave RL diagnostics even
        # untraced, so the report gets policy trends without paying for a
        # full trace.
        if health is True:
            from repro_torch.obs.health import FleetHealth
            health = FleetHealth(self.env.cfg.n_clients)
        self.health = health
        if health is not None and hasattr(server, "collect_rl_diag"):
            server.collect_rl_diag = True

    # ------------------------------------------------------------------ #
    def _available(self, client: int) -> bool:
        return (self.availability is None
                or self.availability.available(client, self.t))

    def _try_dispatch(self) -> bool:
        pol, cfg = self.policy, self.env.cfg
        if self._wave_count >= self._max_waves:
            return False
        if self.time_to_target is not None:
            return False   # target reached: don't train a wave only to stop
        k = cfg.k_per_round
        if pol.name in ("buffered", "async"):
            # keep the in-flight population topped up to k, never above
            k = k - len(self.inflight)
            if k <= 0:
                return False
        elif self._open_waves:
            return False               # barrier policies: one wave at a time
        if self.participation == "sampled":
            clients = self.store.sample_available(k, self.env.rng, self.t,
                                                  self.availability)
        else:
            among = None
            if self.availability is not None or self.inflight:
                if self.store is not None:
                    cands = self.store.candidates()
                    among = (cands if self.availability is None
                             else [c for c in cands if self._available(c)])
                else:
                    among = [c for c in range(cfg.n_clients)
                             if c not in self.inflight and self._available(c)]
            clients = self.env.select_clients(k=k, among=among)
        if not clients:
            self._guard_stall()
            return False
        with self._tr.span("sim.dispatch", wave=self._wave_count,
                           n=len(clients)):
            plan = self.server.plan_wave(clients,
                                         latency_only=self.latency_only,
                                         deterministic=self.deterministic)
            plan.version = self.version
            plan.t_dispatch = self.t
            self.server.train_wave(plan, eval_accuracy=self.eval_accuracy)
        w = self._wave_count
        self._wave_count += 1
        self._open_waves += 1
        m = len(clients)
        info = {"plan": plan, "outstanding": set(range(m)),
                "arrived": [], "done": False}
        self._waves[w] = info
        if self.comm:
            downs = np.array([self.comm.download_time(c, s) for c, s
                              in zip(clients, plan.sizes)])
            ups = np.array([self.comm.upload_time(c, s) for c, s
                            in zip(clients, plan.sizes)])
            for s in plan.sizes:
                self.down_bytes += self.comm.payload_bytes(s,
                                                           direction="down")
        else:
            downs = ups = np.zeros(m)
        # offsets are computed clock-free (down=up=0 reduces to the
        # legacy assess+local, bit for bit) and only then anchored at
        # self.t — `(t + off) - t` would drift a ulp and break parity.
        # One vectorized pass replaces the per-client arithmetic; the
        # operation order matches the old scalar loop exactly.
        a = np.asarray(plan.assess)
        lt = np.asarray(plan.local_times)
        offs = downs + a + lt + ups
        t_assess = self.t + downs + a
        t_arrive = self.t + offs
        if self._tr.enabled:
            # critical-path phase boundaries (cumulative maxima over the
            # cohort): the wave cannot close before the slowest client
            # clears each stage — _finish_wave turns these into nested
            # virtual-clock spans and the assess/local/comm breakdown
            info["phases"] = (float(np.max(downs)), float(np.max(downs + a)),
                              float(np.max(downs + a + lt)),
                              float(np.max(offs)))
            self._tr.instant("dispatch", clock=VIRTUAL, tid="events",
                             wave=w, n=m)
        if self.health is not None:
            # per-client phase offsets for note_wave at resolution (the
            # exact values the events are scheduled from, not estimates)
            info["health"] = (list(clients), list(plan.sizes), a, lt,
                              downs + ups, offs)
            self.health.note_outcome("dispatched", m)
        evs = []
        for i, c in enumerate(clients):
            self.inflight[c] = (w, i)
            evs.append(Event(float(t_assess[i]), ASSESS_DONE, c, w))
            drop_t = (self.availability.next_offline(c, self.t,
                                                     float(t_arrive[i]))
                      if self.availability else None)
            if drop_t is not None:
                evs.append(Event(drop_t, DROPOUT, c, w))
            else:
                evs.append(Event(float(t_arrive[i]), ARRIVAL, c, w))
        if self.store is not None:
            self.store.open_slots(clients, w, list(range(m)), plan.version)
        self.queue.push_batch(evs)
        info["finish"] = [float(o) for o in offs]
        if pol.name == "deadline":
            d = (pol.fixed if pol.fixed is not None
                 else float(np.quantile(info["finish"], pol.quantile)))
            info["deadline"] = self.t + d
            self.queue.push(Event(self.t + d, DEADLINE, -1, w))
        return True

    def _guard_stall(self) -> None:
        """Nobody dispatchable right now: if the queue would otherwise run
        dry, wake up when the first offline client rejoins. Under sampled
        participation only a bounded probe of clients is scanned (an O(n)
        trace walk at 100k clients would dwarf the whole run) — the wakeup
        may be later than the true earliest rejoin, which only delays the
        next dispatch attempt, never drops it."""
        if (self.availability is None or self.inflight or self.queue
                or self._wave_count >= self._max_waves):
            return
        if self.participation == "sampled":
            n = self.env.cfg.n_clients
            probe = self.env.rng.choice(n, size=min(1024, n), replace=False)
        else:
            probe = range(self.env.cfg.n_clients)
        times = [self.availability.next_online(int(c), self.t)
                 for c in probe]
        j = int(np.argmin(times))
        self.queue.push(Event(float(times[j]), REJOIN, int(list(probe)[j]),
                              -1))

    # ------------------------------------------------------------------ #
    def _aggregate(self, entries: List[Tuple[int, int]], stale: bool = True,
                   eval_acc: bool = True) -> None:
        """Fold the listed (wave, index) updates into the globals and log
        an AggRecord. stale=False (sync/deadline: every update trained
        against the current globals) keeps the legacy Eq. 38 weights
        byte-identical — staleness tagging alone would renormalize them.

        The logged straggling spread is over local training times in the
        legacy (comm=None) setting; with a CommModel it is over the full
        turnaround offsets (download + assess + local + upload), so slow
        *links* register as straggling just like slow compute — the spread
        an update codec can actually shrink."""
        pol = self.policy
        updates, lts, stals = [], [], []
        for w, i in entries:
            plan = self._waves[w]["plan"]
            tau = max(self.version - plan.version, 0) if stale else None
            if not self.latency_only:
                updates += self.server.wave_updates(plan, [i], staleness=tau)
            stals.append(0 if tau is None else tau)
            lts.append(self._waves[w]["finish"][i] if self.comm
                       else plan.local_times[i])
        if updates:
            self.server.apply_updates(
                updates,
                staleness_exponent=getattr(pol, "staleness_exponent", 0.5),
                mix=getattr(pol, "mix", 1.0))
        self.version += 1
        rec = AggRecord(time=self.t, version=self.version,
                        n_updates=len(entries), staleness=tuple(stals),
                        straggling=straggling_latency(lts))
        if (eval_acc and self.eval_accuracy and not self.latency_only
                and self.version % self.eval_every == 0):
            self._note_accuracy(rec)
        self.records.append(rec)

    def _note_accuracy(self, rec: AggRecord,
                       acc: Optional[float] = None) -> None:
        if acc is None:
            acc = self.env.test_accuracy(self.server.lite_params,
                                         self.env.lite_cfg)
        rec.acc_lite = acc
        self.acc_curve.append((self.t, acc))
        if (self._target is not None and self.time_to_target is None
                and acc >= self._target):
            self.time_to_target = self.t

    def _flush_buffer(self) -> None:
        entries = [(w, i) for w, i, _ in self.buffer]
        self.buffer = []
        self._aggregate(entries, stale=True)

    def _finish_wave(self, w: int, aggregate: bool) -> None:
        """Wave fully resolved (arrived/dropped/deadlined): RL feedback +
        RoundRecord, in the legacy aggregate -> feedback -> record order."""
        info = self._waves[w]
        info["done"] = True
        self._open_waves -= 1
        plan = info["plan"]
        if aggregate:
            arrived = sorted(i for i, _ in info["arrived"])
            self._aggregate([(w, i) for i in arrived], stale=False,
                            eval_acc=False)
        rw1, rw2 = self.server.feedback_wave(plan)
        sync = isinstance(self.policy, SyncPolicy)
        # sync barrier span = max finish offset, the exact legacy value;
        # other policies close waves at arbitrary clock events
        wall = (max(info["finish"]) if sync
                else self.t - plan.t_dispatch)
        rec = self.server.record_wave(
            plan, rw1, rw2, eval_accuracy=self.eval_accuracy and sync,
            wall_time=wall)
        if self._tr.enabled and "phases" in info:
            self._emit_wave_spans(w, plan, info)
        if self.health is not None and "health" in info:
            clients, sizes, a, lt, comm, offs = info["health"]
            self.health.note_wave(w, plan.t_dispatch,
                                  plan.t_dispatch + wall, clients, sizes,
                                  a, lt, comm, own=offs)
            self.health.note_rl(w, rec.rl_diag)
        if (aggregate and self.records and self.eval_accuracy
                and not self.latency_only):
            if sync:
                # reuse record_wave's evaluation instead of evaluating twice
                self._note_accuracy(self.records[-1], acc=rec.acc_lite)
            elif self.version % self.eval_every == 0:
                self._note_accuracy(self.records[-1])
        self._try_dispatch()

    def _emit_wave_spans(self, w: int, plan, info: Dict) -> None:
        """Emit the wave's virtual-clock spans at resolution: one parent
        wave-barrier span (dispatch -> resolution) carrying the
        assess/local/comm/barrier breakdown SimResult.timing aggregates,
        plus nested critical-path child spans (download -> assess -> local
        -> upload, clipped to the resolution time under deadline drops).
        Each wave gets its own thread row — overlapping open waves under
        buffered/async would otherwise break Perfetto's slice nesting."""
        tr = self._tr
        t0, t1 = plan.t_dispatch, self.t
        cd, ca, cl, cu = info["phases"]
        phases = {"assess": ca - cd, "local": cl - ca,
                  "comm": cd + (cu - cl),
                  "barrier": max((t1 - t0) - cu, 0.0)}
        tid = f"wave{w}"
        # parent first: export's stable sort keeps it ahead of same-ts
        # children, which is what Perfetto's containment nesting expects
        ev = tr.span_at("wave_barrier", t0, max(t0, t1), clock=VIRTUAL,
                        tid=tid, wave=w, n=len(plan.clients),
                        **{k: round(v, 9) for k, v in phases.items()})
        self._wave_spans.append(ev)
        for name, b, e in (("comm_down", 0.0, cd), ("assess", cd, ca),
                           ("local", ca, cl), ("comm_up", cl, cu)):
            b, e = t0 + b, min(t0 + e, t1)
            if e > b:
                tr.span_at(name, b, e, clock=VIRTUAL, tid=tid)

    # ------------------------------------------------------------------ #
    def _on_arrival(self, ev: Event) -> None:
        if self.inflight.get(ev.client, (None, None))[0] != ev.wave:
            return                     # stale event: client dropped/requeued
        w, i = self.inflight.pop(ev.client)
        if self.store is not None:
            self.store.close_slot(ev.client, "update")
        info = self._waves[w]
        info["outstanding"].discard(i)
        info["arrived"].append((i, ev.time))
        self.n_updates += 1
        if self.health is not None:
            self.health.note_outcome("update")
        if self.comm:
            self.up_bytes += self.comm.payload_bytes(
                info["plan"].sizes[i], direction="up")
        pol = self.policy
        if pol.name in ("buffered", "async"):
            self.buffer.append((w, i, ev.time))
            if len(self.buffer) >= pol.buffer_m:
                self._flush_buffer()
            if not info["outstanding"]:
                self._finish_wave(w, aggregate=False)
            self._try_dispatch()
        elif not info["outstanding"] and not info["done"]:
            self._finish_wave(w, aggregate=True)   # sync / early deadline

    def _on_deadline(self, ev: Event) -> None:
        info = self._waves[ev.wave]
        if info["done"]:
            return                     # everyone arrived before the deadline
        plan = info["plan"]
        for i in sorted(info["outstanding"]):
            c = plan.clients[i]
            if self.inflight.get(c) == (ev.wave, i):
                del self.inflight[c]
                if self.store is not None:
                    self.store.close_slot(c, "expired")
            self.n_dropped += 1
            if self.health is not None:
                self.health.note_outcome("expired")
        info["outstanding"].clear()
        self._finish_wave(ev.wave, aggregate=True)

    def _on_dropout(self, ev: Event) -> None:
        if self.inflight.get(ev.client, (None, None))[0] != ev.wave:
            return
        w, i = self.inflight.pop(ev.client)
        if self.store is not None:
            self.store.close_slot(ev.client, "dropped")
        info = self._waves[w]
        info["outstanding"].discard(i)
        self.n_dropped += 1
        if self.health is not None:
            self.health.note_outcome("dropped")
        if self.availability is not None:
            self.queue.push(Event(
                self.availability.next_online(ev.client, ev.time), REJOIN,
                ev.client, -1))
        if not info["outstanding"] and not info["done"]:
            self._finish_wave(w, aggregate=self.policy.name != "buffered"
                              and self.policy.name != "async")
        elif self.policy.name in ("buffered", "async"):
            self._try_dispatch()

    def _on_rejoin(self, ev: Event) -> None:
        if self.health is not None and ev.client >= 0:
            self.health.note_outcome("rejoin")
        self._try_dispatch()

    def _on_assess_done(self, ev: Event) -> None:
        # the decision path runs at dispatch (the server simulates T^d
        # analytically), so this event is observational: it counts how many
        # assessments completed — dropped clients never report theirs
        if self.inflight.get(ev.client, (None, None))[0] == ev.wave:
            self.n_assessed += 1

    # ------------------------------------------------------------------ #
    def run(self, waves: Optional[int] = 10, max_time: float = None,
            target_accuracy: float = None, max_updates: int = None,
            ) -> SimResult:
        """Advance the simulation. `waves` bounds how many more cohorts may
        be dispatched (None = unbounded — then max_time, max_updates or
        target_accuracy must terminate the run). Returns a SimResult;
        cumulative state persists, so run() may be called again —
        target_accuracy and time_to_target are per-call."""
        self._max_waves = (math.inf if waves is None
                           else self._wave_count + waves)
        self._target = target_accuracy
        self.time_to_target = None
        if waves is None and max_time is None and max_updates is None \
                and target_accuracy is None:
            raise ValueError("unbounded run: give waves, max_time, "
                             "max_updates or target_accuracy")
        tr = self._tr = _tracer()   # refresh: enable() may postdate __init__
        self._try_dispatch()
        handlers = {ARRIVAL: self._on_arrival, DEADLINE: self._on_deadline,
                    DROPOUT: self._on_dropout, REJOIN: self._on_rejoin,
                    ASSESS_DONE: self._on_assess_done}
        while self.queue:
            if self.time_to_target is not None:
                break
            if max_updates is not None and self.n_updates >= max_updates:
                break
            ev = self.queue.peek()
            if max_time is not None and ev.time > max_time:
                self.t = max_time
                break
            self.queue.pop()
            self.n_events += 1
            self.t = ev.time
            if tr.enabled:   # one attribute lookup on the untraced hot path
                tr.set_virtual(ev.time)
                tr.instant(ev.kind, clock=VIRTUAL, tid="events",
                           client=ev.client, wave=ev.wave)
                tr.counter("sim.load", {"inflight": len(self.inflight),
                                        "buffer": len(self.buffer)},
                           clock=VIRTUAL)
            handlers[ev.kind](ev)
        if self.buffer and self.time_to_target is None:
            self._flush_buffer()       # don't silently waste late updates
        return self._result()

    def _result(self) -> SimResult:
        stragg = [r.straggling for r in self.records if r.n_updates > 0]
        if self.eval_accuracy and not self.latency_only:
            final = self.env.test_accuracy(self.server.lite_params,
                                           self.env.lite_cfg)
        else:
            final = 0.0
        return SimResult(
            policy=self.policy.name, sim_time=self.t,
            n_waves=self._wave_count, n_aggregations=len(self.records),
            n_updates=self.n_updates, n_dropped=self.n_dropped,
            n_assessed=self.n_assessed, n_events=self.n_events,
            mean_straggling=float(np.mean(stragg)) if stragg else 0.0,
            final_acc=float(final), time_to_target=self.time_to_target,
            up_bytes=self.up_bytes, down_bytes=self.down_bytes,
            acc_curve=list(self.acc_curve), records=list(self.records),
            timing=(wave_timing_summary(self._wave_spans)
                    if self._tr.enabled else None),
            health=(self.health.summary(store=self.store)
                    if self.health is not None else None))
