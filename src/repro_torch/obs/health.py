"""Fleet health analytics (DESIGN.md §16): straggler attribution, drift
detection, and churn rates over the per-wave phase offsets.

`FleetHealth` is fed by whoever owns the clock — the event scheduler
passes the exact per-client dispatch offsets it already computed
(download+assess+local+upload), the parameter service passes measured
ticket turnarounds — one vectorized `note_wave` call per resolved wave.
State is O(clients) numpy arrays over the same dense client-id space as
the SoA `ClientStore` (no per-client Python objects), plus bounded
deques for the per-wave attribution rows and per-size-group samples, so
a 100k-client population costs a few MB and a long run cannot grow
without bound.

Per wave it answers the questions the paper's whole mechanism turns on:

  attribution   which phase (assess / local / comm / barrier) dominates
                the straggler's turnaround — i.e. is the slowest client
                compute-bound (PPO1/PPO2's job) or link/wait-bound
                (codec / policy's job);
  drift         per-client EWMA turnaround baseline with Welford-style
                EWMA variance; a wave whose turnaround lands more than
                `z_thresh` standard deviations from the client's own
                baseline is flagged (slow anomaly = emerging straggler,
                fast anomaly = recovered);
  churn         update/dropout/expiry/rejoin outcome rates, optionally
                cross-checked against the `ClientStore` counters
                (`store.health_counters()`).

Like the tracer, everything here is observational: a run with no
FleetHealth attached is byte-identical to an uninstrumented one (pinned
in tests/test_torch_sim.py).
"""
from __future__ import annotations

from collections import Counter, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

#: phase order of every per-client attribution row (matches
#: repro_torch.obs.trace.WAVE_PHASES)
PHASES = ("assess", "local", "comm", "barrier")


def _percentiles(values) -> Optional[Dict[str, float]]:
    """p50/p99/mean/max of a seconds sample, rounded for JSON stability."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return None
    return {"n": int(vals.size),
            "p50_s": round(float(np.percentile(vals, 50)), 6),
            "p99_s": round(float(np.percentile(vals, 99)), 6),
            "mean_s": round(float(vals.mean()), 6),
            "max_s": round(float(vals.max()), 6)}


class FleetHealth:
    """See module docstring. One instance per scheduler/service run."""

    def __init__(self, n_clients: int, ewma_alpha: float = 0.25,
                 z_thresh: float = 3.0, min_history: int = 3,
                 max_wave_rows: int = 4096, group_window: int = 8192):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.n_clients = int(n_clients)
        self.alpha = float(ewma_alpha)
        self.z_thresh = float(z_thresh)
        self.min_history = int(min_history)
        n = self.n_clients
        # dense per-client state (SoA, same id space as ClientStore)
        self.waves_seen = np.zeros(n, dtype=np.int64)
        self.phase_seconds = np.zeros((n, len(PHASES)), dtype=np.float64)
        self.straggler_waves = np.zeros(n, dtype=np.int64)
        self.ewma = np.full(n, np.nan, dtype=np.float64)
        self.ewma_var = np.zeros(n, dtype=np.float64)
        self.last_turnaround = np.full(n, np.nan, dtype=np.float64)
        self.last_z = np.zeros(n, dtype=np.float64)
        self.slow_anomalies = np.zeros(n, dtype=np.int64)
        self.fast_anomalies = np.zeros(n, dtype=np.int64)
        # bounded logs
        self.n_waves = 0
        self.wave_rows: deque = deque(maxlen=int(max_wave_rows))
        self.rl_rows: deque = deque(maxlen=int(max_wave_rows))
        self.outcomes: Counter = Counter()
        self._group_window = int(group_window)
        self._groups: Dict[str, deque] = {}

    # ------------------------------------------------------------------ #
    # feeds
    # ------------------------------------------------------------------ #
    def note_outcome(self, kind: str, n: int = 1) -> None:
        """Count one client-slot outcome: dispatched / update / dropped /
        expired / rejoin."""
        self.outcomes[kind] += int(n)

    def note_rl(self, wave: int, diag: Optional[Dict]) -> None:
        """Stash one wave's PPO diagnostics (repro_torch.obs.rl shape:
        {"ppo1": {...}, "ppo2": {...}}) for the report's trend view."""
        if diag:
            self.rl_rows.append({"wave": int(wave), **diag})

    def note_wave(self, wave: int, t0: float, t1: float,
                  clients: Sequence[int], sizes: Sequence[str],
                  assess, local, comm, own=None) -> Dict:
        """Fold one resolved wave in. `assess`/`local`/`comm` are the
        per-client phase seconds; `own` is each client's full turnaround
        offset from dispatch (defaults to their sum). The wave barrier
        share is what is left between a client finishing its own work and
        the wave actually resolving at `t1` (slowest-peer wait under
        sync, deadline slack under the service). One vectorized pass —
        O(cohort) numpy. Returns the wave's attribution row."""
        c = np.asarray(clients, dtype=np.int64)
        a = np.asarray(assess, dtype=np.float64)
        lo = np.asarray(local, dtype=np.float64)
        cm = np.asarray(comm, dtype=np.float64)
        own = (a + lo + cm if own is None
               else np.asarray(own, dtype=np.float64))
        span = max(float(t1) - float(t0), 0.0)
        barrier = np.maximum(span - own, 0.0)
        phases = np.stack([a, lo, cm, barrier], axis=1)

        seen_before = self.waves_seen[c]
        self.waves_seen[c] = seen_before + 1
        self.phase_seconds[c] += phases

        # EWMA baseline + z-score drift on each client's own turnaround
        prev = self.ewma[c]
        first = np.isnan(prev)
        diff = np.where(first, 0.0, own - prev)
        sd = np.sqrt(np.maximum(self.ewma_var[c], 0.0))
        ready = (~first) & (seen_before >= self.min_history) & (sd > 1e-12)
        z = np.where(ready, diff / np.where(sd > 1e-12, sd, 1.0), 0.0)
        incr = self.alpha * diff
        self.ewma[c] = np.where(first, own, prev + incr)
        self.ewma_var[c] = np.where(
            first, 0.0, (1.0 - self.alpha) * (self.ewma_var[c] + diff * incr))
        self.last_turnaround[c] = own
        self.last_z[c] = z
        self.slow_anomalies[c] += (z > self.z_thresh)
        self.fast_anomalies[c] += (z < -self.z_thresh)

        # per-size-group turnaround windows
        for s in sorted(set(sizes)):
            d = self._groups.get(s)
            if d is None:
                d = self._groups[s] = deque(maxlen=self._group_window)
            d.extend(float(t) for t, ss in zip(own, sizes) if ss == s)

        # straggler attribution: the slowest client and its dominant phase
        j = int(np.argmax(own))
        dom = int(np.argmax(phases[j]))
        self.straggler_waves[c[j]] += 1
        row = {"wave": int(wave), "n": int(c.size),
               "straggler": int(c[j]), "size": str(sizes[j]),
               "turnaround_s": round(float(own[j]), 6),
               "span_s": round(span, 6),
               "dominant_phase": PHASES[dom],
               "phases_s": {p: round(float(phases[j, i]), 6)
                            for i, p in enumerate(PHASES)},
               "z": round(float(z[j]), 4)}
        self.n_waves += 1
        self.wave_rows.append(row)
        return row

    # ------------------------------------------------------------------ #
    # views (everything JSON-native, sorted where order matters)
    # ------------------------------------------------------------------ #
    def client_attribution(self, top: int = 10) -> List[Dict]:
        """The `top` clients ranked by how often they were the wave
        straggler (ties by total turnaround), each with its per-phase
        share of cumulative turnaround and drift state."""
        totals = self.phase_seconds.sum(axis=1)
        order = np.lexsort((-totals, -self.straggler_waves))
        out = []
        for i in order[:int(top)]:
            if self.waves_seen[i] == 0:
                break
            tot = float(totals[i])
            shares = (self.phase_seconds[i] / tot if tot > 0
                      else np.zeros(len(PHASES)))
            out.append({
                "client": int(i),
                "waves": int(self.waves_seen[i]),
                "straggler_waves": int(self.straggler_waves[i]),
                "dominant_phase": PHASES[int(np.argmax(
                    self.phase_seconds[i]))],
                "phase_share": {p: round(float(shares[k]), 4)
                                for k, p in enumerate(PHASES)},
                "ewma_s": round(float(self.ewma[i]), 6),
                "last_z": round(float(self.last_z[i]), 4),
                "slow_anomalies": int(self.slow_anomalies[i]),
            })
        return out

    def group_stats(self) -> Dict[str, Dict]:
        """Per-size-group turnaround percentiles over the sample window."""
        return {s: _percentiles(d) for s, d in sorted(self._groups.items())}

    def drift_summary(self, top: int = 5) -> Dict:
        """Fleet-level drift/anomaly view from the EWMA baselines."""
        flagged = np.flatnonzero(self.slow_anomalies > 0)
        order = flagged[np.argsort(-self.slow_anomalies[flagged],
                                   kind="stable")]
        return {
            "clients_flagged_slow": int(flagged.size),
            "clients_flagged_fast": int((self.fast_anomalies > 0).sum()),
            "z_thresh": self.z_thresh,
            "top_drifting": [
                {"client": int(i),
                 "slow_anomalies": int(self.slow_anomalies[i]),
                 "ewma_s": round(float(self.ewma[i]), 6),
                 "last_turnaround_s": round(float(self.last_turnaround[i]),
                                            6),
                 "last_z": round(float(self.last_z[i]), 4)}
                for i in order[:int(top)]],
        }

    def churn_summary(self, store=None) -> Dict:
        """Outcome counts + per-wave rates; with a ClientStore, merges
        its vectorized fleet counters (`health_counters`) for the
        authoritative planned/updated/expired totals."""
        waves = max(self.n_waves, 1)
        out = {"outcomes": {k: int(v)
                            for k, v in sorted(self.outcomes.items())},
               "per_wave": {k: round(v / waves, 4)
                            for k, v in sorted(self.outcomes.items())}}
        if store is not None and hasattr(store, "health_counters"):
            out["store"] = store.health_counters()
        return out

    def phase_attribution(self) -> Dict:
        """Fleet-wide phase totals/shares + the dominant-phase histogram
        over the recorded straggler rows."""
        totals = self.phase_seconds.sum(axis=0)
        tot = float(totals.sum())
        dom = Counter(r["dominant_phase"] for r in self.wave_rows)
        return {
            "total_s": {p: round(float(totals[i]), 6)
                        for i, p in enumerate(PHASES)},
            "share": {p: round(float(totals[i] / tot), 4) if tot > 0 else 0.0
                      for i, p in enumerate(PHASES)},
            "straggler_dominant_waves": {p: int(dom.get(p, 0))
                                         for p in PHASES},
        }

    def summary(self, store=None) -> Dict:
        """The full JSON-able health view (what `SimResult.health` and the
        report artifact carry)."""
        return {
            "n_clients": self.n_clients,
            "n_waves": self.n_waves,
            "clients_seen": int((self.waves_seen > 0).sum()),
            "attribution": self.phase_attribution(),
            "stragglers": self.client_attribution(),
            "groups": self.group_stats(),
            "drift": self.drift_summary(),
            "churn": self.churn_summary(store=store),
            "waves": list(self.wave_rows),
            "rl": [dict(r) for r in self.rl_rows],
        }
