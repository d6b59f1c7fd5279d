"""Struct-of-arrays client state for population-scale FL (DESIGN.md §15).

The legacy server keeps per-client state as dicts of Python objects
(ClientProfile instances, per-ticket Ticket objects, EF residual dicts,
per-client availability trace lists). That layout is fine at 10-100
clients and fatal at 100k+: object headers dominate memory, and every
cohort operation is a Python-level loop.

`ClientStore` flips the layout: one contiguous numpy array per field,
indexed by client id. It holds

  * the latency-profile fields (base_speed, dataset_size, drift params)
    that `repro.core.latency.profile_speeds` consumes vectorized,
  * per-client label entropy (the aggregation-weight input),
  * live scheduler/service state: an in-flight mask, ticket slots
    (wave / index / version / deadline), and a churn flag,
  * performance-history / PPO-observation features (last assessment and
    local-training times, last assigned size and intensity) plus
    dispatch/update/expiry counters.

Only *sparse* per-client state stays keyed: EF residuals (`store.ef`,
shared with ``HAPFLServer._ef``) exist only for clients that actually
submitted through a lossy codec, and parameter pytrees are never stored
per client at all — tickets pin dispatch-time globals by reference, so
only the active cohort materializes trees (the memory-shape tests pin
this).

The store is *observational* with respect to learning: nothing in the
aggregation, PPO, or codec math reads the history arrays, so the SoA and
legacy paths produce byte-identical rounds (pinned in
tests/test_population.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.latency import profile_speeds


class ClientStore:
    """Contiguous per-client server state; see module docstring."""

    #: (name, dtype, fill) for every live/history array, in layout order
    _LIVE_FIELDS = (
        ("inflight", np.bool_, False),
        ("churned", np.bool_, False),
        ("ticket_wave", np.int64, -1),
        ("ticket_index", np.int32, -1),
        ("ticket_version", np.int64, -1),
        ("ticket_deadline", np.float64, np.inf),
        ("last_assess", np.float64, np.nan),
        ("last_local", np.float64, np.nan),
        ("last_size", np.int16, -1),
        ("last_intensity", np.int32, -1),
        ("n_planned", np.int64, 0),
        ("n_updates", np.int64, 0),
        ("n_expired", np.int64, 0),
    )

    def __init__(self, base_speed: np.ndarray, dataset_size: np.ndarray,
                 entropy: np.ndarray, size_names: Sequence[str] = (),
                 drift_amp=0.2, drift_period=50.0, jitter_sigma=0.05):
        n = len(base_speed)
        self.n_clients = n
        self.client_id = np.arange(n, dtype=np.int64)
        self.base_speed = np.asarray(base_speed, np.float64)
        self.dataset_size = np.asarray(dataset_size, np.int64)
        self.entropy = np.asarray(entropy, np.float64)
        self.drift_amp = np.broadcast_to(
            np.asarray(drift_amp, np.float64), (n,)).copy()
        self.drift_period = np.broadcast_to(
            np.asarray(drift_period, np.float64), (n,)).copy()
        self.jitter_sigma = np.broadcast_to(
            np.asarray(jitter_sigma, np.float64), (n,)).copy()
        self.size_names = tuple(size_names)
        self._size_index = {s: i for i, s in enumerate(self.size_names)}
        for name, dtype, fill in self._LIVE_FIELDS:
            setattr(self, name, np.full(n, fill, dtype))
        #: sparse EF residual dict, keyed (client, kind, size) — shared by
        #: reference with HAPFLServer._ef so codec state has one home
        self.ef: Dict = {}

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_profiles(cls, profiles, entropies,
                      size_names: Sequence[str] = ()) -> "ClientStore":
        """Mirror a list of ClientProfile objects (the legacy layout) into
        arrays — the small-cohort FLEnvironment path."""
        return cls(
            base_speed=np.array([p.base_speed for p in profiles]),
            dataset_size=np.array([p.dataset_size for p in profiles]),
            entropy=np.asarray(entropies, np.float64),
            size_names=size_names,
            drift_amp=np.array([p.drift_amp for p in profiles]),
            drift_period=np.array([p.drift_period for p in profiles]),
            jitter_sigma=np.array([p.jitter_sigma for p in profiles]))

    @classmethod
    def synthetic(cls, n_clients: int, max_speed_ratio: float,
                  mean_dataset_size: int = 300, seed: int = 0,
                  size_names: Sequence[str] = ()) -> "ClientStore":
        """Population-scale constructor: no per-client objects are ever
        built. Speeds are log-spaced and shuffled exactly like
        `make_heterogeneous_clients`; dataset sizes are lognormal around
        the mean (the non-IID partition analogue) and entropies uniform in
        [0.5, log2(10)], both from a separate counter-keyed stream so the
        speed layout matches the object path for equal (n, ratio, seed)."""
        rng = np.random.default_rng(seed)
        speeds = np.geomspace(1.0, max_speed_ratio, n_clients)
        rng.shuffle(speeds)
        aux = np.random.default_rng(
            np.random.SeedSequence([seed & 0xFFFFFFFF, 0x90901A7]))
        sizes = np.maximum(
            (mean_dataset_size * aux.lognormal(0.0, 0.5, n_clients)), 16.0)
        entropy = aux.uniform(0.5, np.log2(10.0), n_clients)
        return cls(base_speed=speeds, dataset_size=sizes.astype(np.int64),
                   entropy=entropy, size_names=size_names)

    # ------------------------------------------------------------------ #
    # vectorized latency inputs
    # ------------------------------------------------------------------ #
    def speeds_at(self, clients, round_idx: int, seed: int = 0) -> np.ndarray:
        c = np.asarray(clients, np.int64)
        return profile_speeds(self.base_speed[c], c, self.drift_amp[c],
                              self.drift_period[c], self.jitter_sigma[c],
                              round_idx, seed)

    def size_index(self, name: str) -> int:
        return self._size_index.get(name, -1)

    # ------------------------------------------------------------------ #
    # ticket slots (scheduler in-flight marks / service deadlines)
    # ------------------------------------------------------------------ #
    def open_slots(self, clients, wave: int, indices, version: int,
                   deadline: float = np.inf) -> None:
        c = np.asarray(clients, np.int64)
        self.inflight[c] = True
        self.ticket_wave[c] = wave
        self.ticket_index[c] = np.asarray(indices, np.int32)
        self.ticket_version[c] = version
        self.ticket_deadline[c] = deadline

    def close_slot(self, client: int, outcome: str = "update") -> None:
        """Free one slot; outcome in {"update", "expired", "dropped"}
        drives the per-client counters."""
        self.inflight[client] = False
        self.ticket_wave[client] = -1
        self.ticket_index[client] = -1
        self.ticket_version[client] = -1
        self.ticket_deadline[client] = np.inf
        if outcome == "update":
            self.n_updates[client] += 1
        elif outcome == "expired":
            self.n_expired[client] += 1

    def reset_slots(self) -> None:
        """Clear every live slot + churn flag (checkpoint restore)."""
        for name, dtype, fill in self._LIVE_FIELDS[:6]:
            getattr(self, name).fill(fill)

    def expired_clients(self, now: float) -> np.ndarray:
        """In-flight clients whose deadline passed, ordered by
        (deadline, client) — exactly the legacy poll() expiry order."""
        hit = np.flatnonzero(self.inflight & (self.ticket_deadline < now))
        if hit.size == 0:
            return hit
        return hit[np.lexsort((hit, self.ticket_deadline[hit]))]

    def candidates(self) -> np.ndarray:
        """Clients with no open slot, ascending (selection pool)."""
        return np.flatnonzero(~self.inflight)

    # ------------------------------------------------------------------ #
    # sampled participation (population-scale selection)
    # ------------------------------------------------------------------ #
    def sample_available(self, k: int, rng: np.random.Generator, now: float,
                         availability=None,
                         max_tries: Optional[int] = None) -> List[int]:
        """Draw up to k distinct dispatchable clients (not in flight, not
        offline) by rejection sampling — O(k) expected work instead of the
        O(n) full-population filter. Falls back to the exact filtered draw
        when the capped attempts can't fill the cohort (high load / low
        availability), so the result is never spuriously short."""
        n = self.n_clients
        if max_tries is None:
            max_tries = max(32 * k, 256)
        picked: List[int] = []
        seen = set()
        tries = 0
        while len(picked) < k and tries < max_tries:
            c = int(rng.integers(n))
            tries += 1
            if c in seen or self.inflight[c]:
                continue
            if availability is not None and not availability.available(c, now):
                continue
            seen.add(c)
            picked.append(c)
        if len(picked) < k:
            pool = [int(c) for c in self.candidates()
                    if availability is None
                    or availability.available(int(c), now)]
            extra = [c for c in pool if c not in seen]
            take = min(k - len(picked), len(extra))
            if take:
                sel = rng.choice(len(extra), size=take, replace=False)
                picked.extend(extra[int(i)] for i in sel)
        return sorted(picked)

    # ------------------------------------------------------------------ #
    # history / observability
    # ------------------------------------------------------------------ #
    def note_plan(self, clients, assess, local_times, sizes,
                  intensities) -> None:
        """Record one planned wave's per-client features (PPO observation
        history; purely observational — nothing reads it back into the
        learning path)."""
        c = np.asarray(clients, np.int64)
        self.last_assess[c] = np.asarray(assess, np.float64)
        self.last_local[c] = np.asarray(local_times, np.float64)
        self.last_intensity[c] = np.asarray(intensities, np.int32)
        self.last_size[c] = np.asarray(
            [self._size_index.get(s, -1) for s in sizes], np.int16)
        self.n_planned[c] += 1

    def health_counters(self) -> Dict[str, float]:
        """Fleet-wide aggregates of the per-client outcome counters (one
        numpy reduction per field, no per-client Python loop) — the
        ClientStore side of the `repro.obs.health.FleetHealth` churn
        view. `update_rate`/`expiry_rate` are fractions of planned
        slots; `participants` counts clients planned at least once."""
        planned = int(self.n_planned.sum())
        return {
            "n_clients": int(self.n_clients),
            "inflight": int(self.inflight.sum()),
            "churned": int(self.churned.sum()),
            "participants": int((self.n_planned > 0).sum()),
            "planned_total": planned,
            "updates_total": int(self.n_updates.sum()),
            "expired_total": int(self.n_expired.sum()),
            "update_rate": round(
                float(self.n_updates.sum()) / max(planned, 1), 4),
            "expiry_rate": round(
                float(self.n_expired.sum()) / max(planned, 1), 4),
            "max_expired_one_client": int(self.n_expired.max())
            if self.n_clients else 0,
        }

    def nbytes(self) -> int:
        """Total bytes across the dense arrays + sparse EF residuals."""
        total = sum(
            getattr(self, name).nbytes for name in
            ("client_id", "base_speed", "dataset_size", "entropy",
             "drift_amp", "drift_period", "jitter_sigma")
            + tuple(f[0] for f in self._LIVE_FIELDS))
        for state in self.ef.values():
            for leaf in state:
                total += int(np.asarray(leaf).nbytes)
        return total
