"""Long-running HAPFL parameter service (DESIGN.md §14).

Turns the simulator's policies into a deployable system: instead of the
virtual-clock scheduler *simulating* client behaviour, the service reacts
to externally driven requests — a load generator, a CLI, or (eventually)
real clients — arriving in any order:

  dispatch(clients, now) -> tickets   plan one wave for the admitted
                                      clients (PPO1 sizes, PPO2
                                      intensities) and hand each a ticket
                                      carrying the dispatch-time reference
                                      globals, assigned work, and a
                                      deadline
  submit(client, params, now)         ingest one trained update: codec
                                      encode/decode round trip against the
                                      *ticket's* reference (EF residuals
                                      keyed (client, kind, size) on the
                                      server), staleness tag
                                      tau = version - ticket.version,
                                      buffered/async apply via
                                      HAPFLServer.apply_updates
  poll(now)                           expire tickets past their deadline:
                                      churned clients are detected here,
                                      their in-flight slots freed for
                                      reassignment; an expired client that
                                      comes back simply dispatches again
                                      (the rejoin path)

Every entry point takes an explicit caller-owned clock `now` (virtual in
tests/benchmarks, wall in a real deployment); wall-clock *processing*
latency of each call is measured internally and surfaced through
`ServiceMetrics` (p50/p99 dispatch latency, sustained updates/sec).

Durability: `checkpoint()` captures the full mutable state — globals,
LiteModel, both PPO agents (params, optimizer, experience buffers,
pending transitions), EF residuals, env rng, the server's generator (PPO
actions), open tickets including their reference trees, the pending
aggregation buffer, and all counters —
such that kill + `restore()` + continued load is bit-identical to an
uninterrupted run (pinned in tests/test_torch_service.py, and on the
card by chip_smoke.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.latency import AvailabilityModel
from repro_torch.obs.trace import VIRTUAL, current as _tracer
from repro_torch.sim.policies import make_policy
from repro_torch.utils.pytree import tree_leaves

#: policies with a streaming (apply-on-arrival) ingest path; sync/deadline
#: are wave barriers and belong to the simulator, not a live service
STREAMING_POLICIES = ("buffered", "async")

BYTES_F32 = 4.0


def _tree_params(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


@dataclass
class Ticket:
    """One outstanding unit of dispatched work."""
    client: int
    wave: int                 # service wave id (one dispatch call = one wave)
    index: int                # slot within the wave
    size: str                 # PPO1-assigned model size category
    intensity: int            # PPO2-assigned training intensity
    round_idx: int            # server round at planning (latency/codec key)
    version: int              # aggregation count at dispatch (staleness base)
    t_dispatch: float
    deadline: float           # caller-clock expiry (poll() enforces)
    expected: float           # predicted assess+train seconds (deadline base)
    ref_local: Any = field(repr=False, default=None)
    ref_lite: Any = field(repr=False, default=None)


@dataclass
class SubmitReceipt:
    accepted: bool
    reason: str = "ok"
    version: int = 0          # server version after any triggered flush
    staleness: int = 0        # tau at ingest (vs the ticket's dispatch)
    wire_bytes: float = 0.0
    aggregated: bool = False  # did this submit trigger a flush?


class ParamService:
    """See module docstring. `server` is a ready HAPFLServer; the service
    owns no learning machinery of its own — it routes externally-driven
    events into the server's wave callbacks and keeps the durable state.
    """

    def __init__(self, server, policy="async",
                 availability: Optional[AvailabilityModel] = None,
                 max_inflight: Optional[int] = None,
                 deadline_factor: float = 3.0, min_deadline: float = 0.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 event_log_size: int = 2000, health=None, slos=None,
                 slo_every: float = 5.0):
        from repro_torch.service.metrics import ServiceMetrics
        if isinstance(policy, str):
            policy = make_policy(policy)
        if policy.name not in STREAMING_POLICIES:
            raise ValueError(
                f"ParamService needs a streaming policy {STREAMING_POLICIES},"
                f" got {policy.name!r} (sync/deadline are simulator barriers)")
        self.server = server
        self.policy = policy
        self.availability = availability
        self.max_inflight = (server.env.cfg.k_per_round
                             if max_inflight is None else int(max_inflight))
        self.deadline_factor = float(deadline_factor)
        self.min_deadline = float(min_deadline)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.metrics = ServiceMetrics(event_log_size=event_log_size)

        self.version = 0                       # server aggregation count
        self.tickets: Dict[int, Ticket] = {}   # client -> open ticket
        self.buffer: List[Dict] = []           # decoded updates pending flush
        self.records: List[Dict] = []          # one entry per aggregation
        self._waves: Dict[int, Dict] = {}      # open waves (RL feedback)
        self._wave_count = 0
        self._expired_once = set()             # clients seen churning (rejoin)
        # struct-of-arrays client state (DESIGN.md §15): ticket slots and
        # churn flags mirror into it so deadline expiry and churn checks
        # are array scans, not dict walks; the tickets dict stays the
        # source of truth for reference pytrees (bounded by max_inflight —
        # only the active cohort materializes trees)
        self.store = getattr(server, "store", None)
        # fleet health + SLOs (repro_torch.obs.health / .slo): both
        # observational — a service without them is byte-identical to one
        # never offered them. health=True builds a default tracker; slos
        # may be an SLOSet or a list of SLO declarations, evaluated in
        # poll() every `slo_every` caller-clock seconds and surfaced as
        # slo.<name>.{value,burn_rate,ok} gauges + transition events.
        if health is True:
            from repro_torch.obs.health import FleetHealth
            health = FleetHealth(server.env.cfg.n_clients)
        self.health = health
        if health is not None and hasattr(server, "collect_rl_diag"):
            server.collect_rl_diag = True
        if slos is not None and not hasattr(slos, "evaluate"):
            from repro_torch.obs.slo import SLOSet
            slos = SLOSet(slos)
        self.slos = slos
        self.slo_every = float(slo_every)
        self._slo_next = -np.inf               # evaluate on the first poll
        self._slo_status: Dict[str, str] = {}

    # ------------------------------------------------------------------ #
    # dispatch path
    # ------------------------------------------------------------------ #
    def dispatch(self, clients: Union[int, Sequence[int]], now: float = 0.0,
                 ) -> List[Ticket]:
        """Admit + plan one wave for the given client(s). Ineligible
        clients (already in flight, at capacity, offline) are skipped and
        counted per reason; the returned tickets cover the admitted set."""
        tr = _tracer()
        if tr.enabled:
            tr.set_virtual(now)
        with tr.span("service.dispatch", now=round(float(now), 6)):
            return self._dispatch(clients, now)

    def _dispatch(self, clients, now: float) -> List[Ticket]:
        t0 = time.perf_counter()
        self.poll(now)
        if isinstance(clients, (int, np.integer)):
            clients = [int(clients)]
        admitted: List[int] = []
        for c in map(int, clients):
            if c in self.tickets:
                reason = "inflight"
            elif len(self.tickets) + len(admitted) >= self.max_inflight:
                reason = "busy"
            elif (self.availability is not None
                  and not self.availability.available(c, now)):
                reason = "offline"
            else:
                admitted.append(c)
                if self._churn_rejoined(c):
                    self.metrics.bump("rejoin")
                    self.metrics.log(now, "rejoin", client=c)
                    if self.health is not None:
                        self.health.note_outcome("rejoin")
                continue
            self.metrics.bump(f"reject_dispatch_{reason}")
            self.metrics.log(now, "reject_dispatch", client=c, reason=reason)
        tickets: List[Ticket] = []
        if admitted:
            plan = self.server.plan_wave(admitted)
            plan.version = self.version
            plan.t_dispatch = now
            # the service never trains server-side: accuracy slots stay 0
            # (weights are then entropy x staleness) and no params are held
            m = len(admitted)
            plan.client_params = []
            plan.accs_local = [0.0] * m
            plan.accs_lite = [0.0] * m
            w = self._wave_count
            self._wave_count += 1
            self._waves[w] = {"plan": plan, "outstanding": set(range(m))}
            for i, c in enumerate(admitted):
                expected = plan.assess[i] + plan.local_times[i]
                tk = Ticket(
                    client=c, wave=w, index=i, size=plan.sizes[i],
                    intensity=int(plan.intensities[i]),
                    round_idx=plan.round_idx, version=self.version,
                    t_dispatch=now,
                    deadline=now + max(self.deadline_factor * expected,
                                       self.min_deadline),
                    expected=expected,
                    # aggregation builds new global trees and never writes
                    # a global tensor in place, so holding references (not
                    # copies) pins the dispatch-time globals exactly
                    # (tests/test_torch_service.py holds a ticket's
                    # reference bitwise across later aggregations)
                    ref_local=self.server.global_by_size[plan.sizes[i]],
                    ref_lite=self.server.lite_params)
                self.tickets[c] = tk
                tickets.append(tk)
                self.metrics.down_bytes += BYTES_F32 * (
                    _tree_params(tk.ref_local) + _tree_params(tk.ref_lite))
                self.metrics.bump("dispatch")
                self.metrics.log(now, "dispatch", client=c, wave=w,
                                 size=tk.size, intensity=tk.intensity,
                                 version=self.version,
                                 deadline=round(tk.deadline, 6))
            if self.store is not None:
                self.store.open_slots(admitted, w, list(range(m)),
                                      self.version,
                                      [tk.deadline for tk in tickets])
            if self.health is not None:
                self.health.note_outcome("dispatched", m)
        self.metrics.dispatch_s.append(time.perf_counter() - t0)
        return tickets

    # ------------------------------------------------------------------ #
    # ingest path
    # ------------------------------------------------------------------ #
    def submit(self, client: int, params: Dict, now: float = 0.0,
               acc_local: float = 0.0, acc_lite: float = 0.0,
               ) -> SubmitReceipt:
        """Ingest one trained `{"local": ..., "lite": ...}` update from an
        open ticket holder. The update is round-tripped through the
        server's codec against the ticket's dispatch-time reference (EF
        residuals persist on the server), tagged with its staleness, and
        applied per the streaming policy."""
        tr = _tracer()
        if tr.enabled:
            tr.set_virtual(now)
        with tr.span("service.submit", client=int(client)):
            return self._submit(client, params, now, acc_local, acc_lite)

    def _submit(self, client, params, now, acc_local, acc_lite,
                ) -> SubmitReceipt:
        t0 = time.perf_counter()
        self.poll(now)
        client = int(client)
        tk = self.tickets.pop(client, None)
        if tk is None:
            self.metrics.bump("reject_submit_no_ticket")
            self.metrics.log(now, "reject_submit", client=client,
                             reason="no_ticket")
            self.metrics.submit_s.append(time.perf_counter() - t0)
            return SubmitReceipt(False, "no_ticket", version=self.version)
        if self.store is not None:
            self.store.close_slot(client, "update")
        if self.health is not None:
            self.health.note_outcome("update")
        decoded, wire = self._ingest_decode(tk, params)
        tau = max(self.version - tk.version, 0)
        self.metrics.up_bytes += wire
        self.buffer.append({
            "client": client, "size": tk.size, "params": decoded,
            "entropy": self.server.env.entropies[client],
            "acc_local": float(acc_local), "acc_lite": float(acc_lite),
            "version": tk.version})
        self.metrics.bump("submit")
        self.metrics.log(now, "submit", client=client, wave=tk.wave,
                         staleness=tau, wire_bytes=round(wire, 1),
                         buffered=len(self.buffer))
        aggregated = False
        if len(self.buffer) >= self.policy.buffer_m:
            self._flush(now)
            aggregated = True
        self._resolve(tk, now, expired=False)
        self.metrics.submit_s.append(time.perf_counter() - t0)
        return SubmitReceipt(True, version=self.version, staleness=tau,
                             wire_bytes=wire, aggregated=aggregated)

    def _ingest_decode(self, tk: Ticket, params: Dict):
        """Codec round trip against the ticket's reference globals —
        the streaming analogue of HAPFLServer._encode_wave, one client at
        a time, with the EF residuals living in server._ef unchanged."""
        codec = self.server.codec
        refs = (("local", tk.size, tk.ref_local), ("lite", "", tk.ref_lite))
        if codec is None:
            return ({k: params[k] for k, _, _ in refs},
                    BYTES_F32 * sum(_tree_params(r) for _, _, r in refs))
        decoded, total = {}, 0.0
        for kind, sz, ref in refs:
            key = (tk.client, kind, sz)
            enc, state = codec.encode(
                params[kind], ref, self.server._ef.get(key),
                seed=self.server.codec_seed, client=tk.client,
                round_idx=tk.round_idx, tag=kind)
            if state is not None:
                self.server._ef[key] = state
            decoded[kind] = codec.decode(enc, ref)
            total += enc.wire_bytes
        return decoded, total

    def _flush(self, now: float) -> None:
        """Fold the pending buffer into the globals. Staleness is measured
        at flush time (aggregations since each update's dispatch), exactly
        like the simulator's buffered/async paths."""
        entries, self.buffer = self.buffer, []
        taus = [max(self.version - e["version"], 0) for e in entries]
        updates = [{"client": e["client"], "size": e["size"],
                    "params": e["params"], "entropy": e["entropy"],
                    "acc_local": e["acc_local"], "acc_lite": e["acc_lite"],
                    "staleness": tau}
                   for e, tau in zip(entries, taus)]
        self.server.apply_updates(
            updates,
            staleness_exponent=getattr(self.policy, "staleness_exponent",
                                       0.5),
            mix=getattr(self.policy, "mix", 1.0))
        self.version += 1
        for tau in taus:
            self.metrics.note_staleness(tau)
        self.metrics.bump("aggregate")
        self.records.append({"t": round(float(now), 6),
                             "version": self.version,
                             "n_updates": len(updates),
                             "staleness": taus})
        self.metrics.log(now, "aggregate", version=self.version,
                         n_updates=len(updates), staleness=taus)
        tr = _tracer()
        if tr.enabled:
            tr.counter("service.state",
                       {"version": self.version, "inflight": self.inflight,
                        "buffered": len(self.buffer)},
                       clock=VIRTUAL, t=float(now))
        if (self.checkpoint_every and self.checkpoint_dir
                and self.version % int(self.checkpoint_every) == 0):
            self.checkpoint()

    # ------------------------------------------------------------------ #
    # churn path
    # ------------------------------------------------------------------ #
    def poll(self, now: float) -> int:
        """Expire tickets whose deadline has passed — how clients that
        disappeared mid-round are detected. Their slots free up for the
        next dispatch; a later submit against an expired ticket is
        rejected (`no_ticket`). With a ClientStore the scan is a
        vectorized array pass in the same (deadline, client) order as the
        legacy dict walk."""
        with _tracer().span("service.poll"):
            return self._poll(now)

    def _poll(self, now: float) -> int:
        if self.store is not None:
            expired = [self.tickets[int(c)]
                       for c in self.store.expired_clients(now)]
        else:
            expired = sorted((tk for tk in self.tickets.values()
                              if tk.deadline < now),
                             key=lambda tk: (tk.deadline, tk.client))
        for tk in expired:
            del self.tickets[tk.client]
            if self.store is not None:
                self.store.close_slot(tk.client, "expired")
            self._note_expired(tk.client)
            self.metrics.bump("expired")
            self.metrics.log(now, "expire", client=tk.client, wave=tk.wave,
                             deadline=round(tk.deadline, 6))
            if self.health is not None:
                self.health.note_outcome("expired")
            self._resolve(tk, now, expired=True)
        if self.slos is not None and now >= self._slo_next:
            self._slo_next = float(now) + self.slo_every
            self._check_slos(now)
        return len(expired)

    def _check_slos(self, now: float) -> None:
        """Evaluate the SLO set against the live registry; surface each
        as gauges (the Prometheus exposition picks them up) and log a
        structured event whenever an SLO's status transitions."""
        r = self.metrics.registry
        for row in self.slos.evaluate(registry=r):
            name = row["name"]
            r.gauge(f"slo.{name}.burn_rate").set(row["burn_rate"])
            r.gauge(f"slo.{name}.ok").set(
                1.0 if row["status"] in ("ok", "no_data") else 0.0)
            if row["value"] is not None:
                r.gauge(f"slo.{name}.value").set(row["value"])
            prev = self._slo_status.get(name)
            if row["status"] != prev:
                self._slo_status[name] = row["status"]
                self.metrics.bump(f"slo_{row['status']}")
                self.metrics.log(now, "slo", name=name,
                                 status=row["status"], value=row["value"],
                                 burn_rate=row["burn_rate"])

    def _note_expired(self, client: int) -> None:
        if self.store is not None:
            self.store.churned[client] = True
        else:
            self._expired_once.add(client)

    def _churn_rejoined(self, client: int) -> bool:
        """Was the client seen churning since its last dispatch? Clears
        the flag (one rejoin count per churn episode)."""
        if self.store is not None:
            if self.store.churned[client]:
                self.store.churned[client] = False
                return True
            return False
        if client in self._expired_once:
            self._expired_once.discard(client)
            return True
        return False

    def _churned_clients(self) -> List[int]:
        """Sorted churn set (checkpointing), whichever backend holds it."""
        if self.store is not None:
            return [int(c) for c in np.flatnonzero(self.store.churned)]
        return sorted(int(c) for c in self._expired_once)

    def _resolve(self, tk: Ticket, now: float, expired: bool) -> None:
        """Mark a wave slot done (arrived or expired); when the whole wave
        is resolved, run the legacy RL feedback + bookkeeping."""
        info = self._waves.get(tk.wave)
        if info is None:
            return
        info["outstanding"].discard(tk.index)
        if self.health is not None:
            info.setdefault("resolved", []).append((tk.index, float(now)))
        if info["outstanding"]:
            return
        plan = info["plan"]
        del self._waves[tk.wave]
        rw1, rw2 = self.server.feedback_wave(plan)
        rec = self.server.record_wave(plan, rw1, rw2, eval_accuracy=False,
                                      wall_time=now - plan.t_dispatch)
        if self.health is not None:
            self._note_health_wave(tk.wave, plan, info.get("resolved", ()),
                                   now)
            self.health.note_rl(tk.wave, rec.rl_diag)
        self.metrics.bump("wave_done")
        self.metrics.log(now, "wave_done", wave=tk.wave,
                         reward_ppo1=round(float(rw1), 4),
                         reward_ppo2=round(float(rw2), 4))
        tr = _tracer()
        if tr.enabled:
            tr.span_at("wave_barrier", plan.t_dispatch,
                       max(float(now), plan.t_dispatch), clock=VIRTUAL,
                       tid=f"wave{tk.wave}", wave=tk.wave,
                       n=len(plan.clients), expired=int(expired))

    def _note_health_wave(self, wave: int, plan, resolved, now: float,
                          ) -> None:
        """Feed one fully resolved wave into FleetHealth. The service
        measures true per-slot turnarounds (resolution time - dispatch);
        the plan's *predicted* assess/local seconds are scaled into each
        turnaround (a slot cannot have spent more than it took) and the
        unexplained remainder is attributed to comm — transport plus
        deadline slack, exactly the share the simulator charges to
        links."""
        res = sorted(resolved)
        if not res:
            return
        idx = [i for i, _ in res]
        t = np.asarray([tt for _, tt in res], dtype=np.float64)
        own = np.maximum(t - plan.t_dispatch, 0.0)
        a = np.asarray([plan.assess[i] for i in idx], dtype=np.float64)
        lo = np.asarray([plan.local_times[i] for i in idx],
                        dtype=np.float64)
        pred = a + lo
        scale = np.where(pred > 0,
                         np.minimum(own / np.maximum(pred, 1e-12), 1.0),
                         0.0)
        a, lo = a * scale, lo * scale
        comm = np.maximum(own - a - lo, 0.0)
        self.health.note_wave(wave, plan.t_dispatch, float(now),
                              [plan.clients[i] for i in idx],
                              [plan.sizes[i] for i in idx],
                              a, lo, comm, own=own)

    # ------------------------------------------------------------------ #
    # inspection
    # ------------------------------------------------------------------ #
    @property
    def inflight(self) -> int:
        return len(self.tickets)

    def evaluate(self) -> Dict[str, float]:
        """On-demand global test accuracy (lite + every size category)."""
        env = self.server.env
        out = {"lite": env.test_accuracy(self.server.lite_params,
                                         env.lite_cfg)}
        for s, c in env.pool.items():
            out[f"local_{s}"] = env.test_accuracy(
                self.server.global_by_size[s], c)
        return out

    # ------------------------------------------------------------------ #
    # durability
    # ------------------------------------------------------------------ #
    def checkpoint(self, path: Optional[str] = None) -> str:
        """Write the full service state; defaults to
        `<checkpoint_dir>/ckpt-<version>`. Returns the path prefix."""
        from repro_torch.service.snapshot import save_service
        if path is None:
            if self.checkpoint_dir is None:
                raise ValueError("no path given and no checkpoint_dir set")
            path = f"{self.checkpoint_dir}/ckpt-{self.version:08d}"
        t0 = time.perf_counter()
        save_service(self, path)
        self.metrics.checkpoint_s.append(time.perf_counter() - t0)
        self.metrics.bump("checkpoint")
        return path

    def restore(self, path: str) -> None:
        """Restore state saved by `checkpoint` into this (freshly
        constructed, same-config) service. Continued operation is
        bit-identical to never having stopped."""
        from repro_torch.service.snapshot import restore_service
        restore_service(self, path)
        self.metrics.bump("restore")
