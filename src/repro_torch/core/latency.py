"""Client latency / performance model (paper §III.B, Eqs. 6-10).

The paper simulates heterogeneous clients on one server; we do the same with
an analytic model: per-epoch time = dataset_size * model_cost / speed, with
a time-varying speed (slow sinusoidal drift + lognormal jitter) so the RL
agents face a *dynamic* environment (paper §IV.B). All times are seconds.

Jitter is **counter-based**: a pure function of (seed, client_id, round_idx),
never a shared generator. The event-driven scheduler (repro.sim) queries
client latencies in arrival order, not cohort order, so a shared-stream
draw would make the simulated environment depend on the scheduling policy;
counter-based draws make sync and event-driven runs byte-identical.

Also here: the communication model (upload/download time = payload bytes /
per-client bandwidth) and on/off availability traces used by the
event-driven simulator (DESIGN.md §10).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_M64 = (1 << 64) - 1
_U64 = np.uint64


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 avalanche over a uint64 ndarray (wrapping arithmetic)."""
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def _entropy_u64(e) -> np.ndarray:
    if isinstance(e, np.ndarray):
        return e.astype(_U64)
    return _U64(int(e) & _M64)


def counter_normal_array(*entropy) -> np.ndarray:
    """Vectorized counter-keyed standard-normal draws: each entropy item is
    an int or an integer ndarray; items broadcast together, and element i
    of the result equals the scalar draw keyed by element i of every item.
    Scalar-only inputs yield a shape-(1,) array. One splitmix64 avalanche
    per entropy item + Box-Muller, all in uint64/float64 numpy — the SoA
    population path draws a whole cohort's jitter in one call."""
    shape = np.broadcast_shapes(*(np.shape(e) for e in entropy))
    flat = shape if shape else (1,)
    x = np.zeros(flat, _U64)
    for e in entropy:
        x = _splitmix64_np(x ^ np.broadcast_to(_entropy_u64(e), flat))
    u1 = np.maximum((_splitmix64_np(x) >> _U64(11)) / float(1 << 53), 1e-12)
    u2 = (_splitmix64_np(x + _U64(1)) >> _U64(11)) / float(1 << 53)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def _counter_normal(*entropy: int) -> float:
    """Standard-normal draw keyed purely by the given integers (splitmix64
    avalanche + Box-Muller) — the same value no matter when or in what
    order it is queried. Delegates to the vectorized kernel so the scalar
    (legacy dict-of-objects) and array (SoA population) paths are bitwise
    identical by construction."""
    return float(counter_normal_array(*entropy)[0])


def profile_speeds(base_speed, client_id, drift_amp, drift_period,
                   jitter_sigma, round_idx: int, seed: int = 0) -> np.ndarray:
    """Vectorized ClientProfile.speed_at over parallel per-client arrays
    (sinusoidal drift + counter-keyed lognormal jitter). Scalars broadcast;
    ClientProfile.speed_at routes through here with size-1 inputs, so both
    paths share every floating-point op."""
    base_speed = np.asarray(base_speed, np.float64)
    client_id = np.asarray(client_id, np.int64)
    drift_amp = np.asarray(drift_amp, np.float64)
    drift = 1.0 + drift_amp * np.sin(
        2 * np.pi * round_idx / np.asarray(drift_period, np.float64)
        + client_id)
    jitter = np.exp(np.asarray(jitter_sigma, np.float64)
                    * counter_normal_array(seed, client_id, round_idx))
    return base_speed * np.maximum(drift, 0.05) * jitter


def _counter_rng(*entropy: int) -> np.random.Generator:
    """A fresh Generator keyed purely by the given integers — the same
    stream no matter when or in what order it is created. Used where the
    construction cost is amortized over a whole lazily-extended stream
    (availability traces), not per draw."""
    return np.random.default_rng(
        np.random.SeedSequence([int(e) & 0xFFFFFFFF for e in entropy]))


@dataclass
class ClientProfile:
    client_id: int
    base_speed: float          # effective samples*cost-units per second
    dataset_size: int
    drift_amp: float = 0.2     # slow sinusoidal capability drift
    drift_period: float = 50.0
    jitter_sigma: float = 0.05 # per-round lognormal noise

    def speed_at(self, round_idx: int, seed: int = 0) -> float:
        # lognormal(0, sigma) jitter = exp(sigma * N(0, 1)), counter-keyed;
        # shares the vectorized kernel with the SoA population path
        return float(profile_speeds(
            self.base_speed, self.client_id, self.drift_amp,
            self.drift_period, self.jitter_sigma, round_idx, seed)[0])


def make_heterogeneous_clients(n_clients: int, max_speed_ratio: float,
                               dataset_sizes: Sequence[int], seed: int = 0,
                               ) -> List[ClientProfile]:
    """Speeds log-spaced across `max_speed_ratio` (paper: 10x/20x/50x)."""
    rng = np.random.default_rng(seed)
    speeds = np.geomspace(1.0, max_speed_ratio, n_clients)
    rng.shuffle(speeds)
    return [ClientProfile(i, float(s), int(d))
            for i, (s, d) in enumerate(zip(speeds, dataset_sizes))]


class LatencyModel:
    """Computes T^d (assessment), T^l (local training) per Eqs. 7-10.

    All queries are idempotent pure functions of (client, round): the same
    (client, round) pair always yields the same time, regardless of how
    often or in what order the scheduler asks.
    """

    def __init__(self, model_costs: Dict[str, float], lite_cost: float,
                 cost_scale: float = 1e-6, seed: int = 0):
        """model_costs: per-size-category per-sample cost (~params)."""
        self.model_costs = dict(model_costs)
        self.lite_cost = float(lite_cost)
        self.cost_scale = cost_scale
        self.seed = seed

    def assessment_time(self, profile: ClientProfile, round_idx: int) -> float:
        """T^d: one LiteModel epoch (paper §IV.B)."""
        speed = profile.speed_at(round_idx, self.seed)
        return profile.dataset_size * self.lite_cost * self.cost_scale / speed

    def local_train_time(self, profile: ClientProfile, round_idx: int,
                         size_name: str, intensity: int,
                         include_lite: bool = True) -> float:
        """T^l: `intensity` local iterations of (local model [+ LiteModel])
        mutual-learning training (Eq. 9-10). Baselines without a LiteModel
        pass include_lite=False."""
        speed = profile.speed_at(round_idx, self.seed)
        cost = self.model_costs[size_name] + (self.lite_cost if include_lite
                                              else 0.0)
        per_epoch = profile.dataset_size * cost * self.cost_scale / speed
        return max(int(intensity), 1) * per_epoch

    def relative_time_ratio(self, size_name: str) -> float:
        """M(.) in Eq. 24: cost of category relative to the LiteModel."""
        return (self.model_costs[size_name] + self.lite_cost) / self.lite_cost

    # ---- vectorized (struct-of-arrays) queries -------------------------- #
    # element i of each result is bitwise equal to the corresponding scalar
    # query: the scalar path delegates to the same kernels, so the SoA
    # population path and the legacy per-profile loop cannot diverge.
    def assessment_times(self, store, clients, round_idx: int) -> np.ndarray:
        """T^d for a whole cohort out of a ClientStore, one numpy pass."""
        c = np.asarray(clients, np.int64)
        speed = store.speeds_at(c, round_idx, self.seed)
        return store.dataset_size[c] * self.lite_cost * self.cost_scale / speed

    def local_train_times(self, store, clients, round_idx: int,
                          size_names: Sequence[str], intensities,
                          include_lite: bool = True) -> np.ndarray:
        """T^l for a whole cohort out of a ClientStore, one numpy pass."""
        c = np.asarray(clients, np.int64)
        speed = store.speeds_at(c, round_idx, self.seed)
        lite = self.lite_cost if include_lite else 0.0
        cost = np.asarray([self.model_costs[s] + lite for s in size_names],
                          np.float64)
        per_epoch = store.dataset_size[c] * cost * self.cost_scale / speed
        return np.maximum(np.asarray(intensities, np.int64), 1) * per_epoch


def straggling_latency(times: Sequence[float]) -> float:
    """Eq. 8: max - min over participating clients. Completion sets of 0 or
    1 clients (deadline drops, async apply-on-arrival) have no spread."""
    if len(times) < 2:
        return 0.0
    return float(max(times) - min(times))


# --------------------------------------------------------------------- #
# communication + availability (event-driven simulator, DESIGN.md §10)
# --------------------------------------------------------------------- #
@dataclass
class CommModel:
    """Up/down link times: payload bytes / per-client bandwidth (bytes/s).

    The payload a HAPFL client moves each round is its size-category local
    model plus the LiteModel (mutual KD ships both); baselines without a
    LiteModel pass include_lite=False.

    `codec` (a repro.comm Codec, or None for dense float32) makes the
    accounting codec-aware: uploads are priced at the codec's analytic
    wire bytes — `codec.wire_bytes(n_params, n_tensors)` — instead of
    `params * bytes_per_param`. Downloads stay dense (the server
    broadcasts full globals) unless `codec_downlink=True`. The per-size
    tensor counts feed the codec's per-tensor overheads (affine maps,
    top-k counts); omitted sizes are priced with zero overhead.
    """
    model_bytes: Dict[str, float]
    lite_bytes: float
    up_bw: List[float]
    down_bw: List[float]
    codec: Optional[object] = None           # repro.comm.Codec
    codec_downlink: bool = False
    bytes_per_param: float = 4.0
    model_tensors: Dict[str, int] = field(default_factory=dict)
    lite_tensors: int = 0

    def __post_init__(self):
        # codecs define their wire format against a float32 dense baseline
        # (4 B/param); pricing them against a different dense width would
        # silently skew every reduction ratio — reject it up front
        if self.codec is not None and self.bytes_per_param != 4.0:
            raise ValueError("codec-aware accounting assumes float32 dense "
                             f"(bytes_per_param=4), got {self.bytes_per_param}")

    def _coded_bytes(self, dense: float, n_tensors: int) -> float:
        return self.codec.wire_bytes(dense / self.bytes_per_param, n_tensors)

    def payload_bytes(self, size_name: str, include_lite: bool = True,
                      direction: str = "up") -> float:
        if self.codec is None or (direction == "down"
                                  and not self.codec_downlink):
            return self.model_bytes[size_name] + (self.lite_bytes
                                                  if include_lite else 0.0)
        total = self._coded_bytes(self.model_bytes[size_name],
                                  self.model_tensors.get(size_name, 0))
        if include_lite:
            total += self._coded_bytes(self.lite_bytes, self.lite_tensors)
        return total

    def upload_time(self, client: int, size_name: str,
                    include_lite: bool = True) -> float:
        return (self.payload_bytes(size_name, include_lite, "up")
                / self.up_bw[client])

    def download_time(self, client: int, size_name: str,
                      include_lite: bool = True) -> float:
        return (self.payload_bytes(size_name, include_lite, "down")
                / self.down_bw[client])


def make_comm_model(model_params: Dict[str, float], lite_params: float,
                    n_clients: int, mean_mbps: float = 20.0,
                    bw_ratio: float = 10.0, down_up_ratio: float = 4.0,
                    bytes_per_param: float = 4.0, seed: int = 0,
                    codec=None, codec_downlink: bool = False,
                    model_tensors: Optional[Dict[str, int]] = None,
                    lite_tensors: int = 0) -> CommModel:
    """Uplinks log-spaced across `bw_ratio` (mirroring the compute-speed
    disparity), shuffled independently of compute speed; downlinks are
    `down_up_ratio` faster (typical asymmetric last-mile links).

    `codec` may be a repro.comm Codec or a codec name ("topk+int8", ...);
    see CommModel for how it changes the payload accounting."""
    rng = np.random.default_rng(seed + 1013)
    up = np.geomspace(1.0, bw_ratio, n_clients)
    rng.shuffle(up)
    up = up * (mean_mbps * 1e6 / 8.0) / up.mean()   # bytes/sec, given mean
    if isinstance(codec, str):
        raise NotImplementedError(
            "codec names need repro_torch.comm, not ported yet "
            "(ROADMAP.md §1 item 9)")
    return CommModel(
        model_bytes={s: p * bytes_per_param for s, p in model_params.items()},
        lite_bytes=lite_params * bytes_per_param,
        up_bw=[float(b) for b in up],
        down_bw=[float(b * down_up_ratio) for b in up],
        codec=codec, codec_downlink=codec_downlink,
        bytes_per_param=bytes_per_param,
        model_tensors=dict(model_tensors or {}), lite_tensors=lite_tensors)


class AvailabilityModel:
    """Per-client on/off availability traces: alternating exponential
    on/off durations, generated lazily from a per-client counter-based
    stream — query order can never change a trace. All clients start
    online; transition k (0-based) of a client's trace flips on->off when
    k is even, off->on when odd.

    Traces live in a bounded LRU cache (`max_cached` clients; 0 disables
    the bound): a 100k-client population only ever materializes the traces
    of recently queried clients. Eviction is purity-safe — each client's
    stream is counter-keyed, so a cold trace regenerates bit-identically
    from t=0 on the next query (it costs the regeneration walk, nothing
    else). `n_evicted` counts evictions for the population bench.
    """

    def __init__(self, n_clients: int, mean_on: float = 600.0,
                 mean_off: float = 120.0, seed: int = 0,
                 max_cached: int = 4096):
        self.n_clients = n_clients
        self.mean_on = float(mean_on)
        self.mean_off = float(mean_off)
        self.seed = seed
        self.max_cached = int(max_cached)
        self.n_evicted = 0
        # client -> (counter-keyed rng, transition times), LRU-ordered
        self._traces: "OrderedDict[int, Tuple[np.random.Generator, List[float]]]" = OrderedDict()

    @property
    def cached_traces(self) -> int:
        return len(self._traces)

    def trace_transitions(self) -> int:
        """Total materialized transition count (memory accounting)."""
        return sum(len(ts) for _, ts in self._traces.values())

    def _extend(self, client: int, until: float) -> List[float]:
        ent = self._traces.get(client)
        if ent is None:
            ent = (_counter_rng(self.seed, client, 0xA5A11AB), [])
            self._traces[client] = ent
            if self.max_cached and len(self._traces) > self.max_cached:
                self._traces.popitem(last=False)
                self.n_evicted += 1
        else:
            self._traces.move_to_end(client)
        rng, ts = ent
        while not ts or ts[-1] <= until:
            mean = self.mean_on if len(ts) % 2 == 0 else self.mean_off
            prev = ts[-1] if ts else 0.0
            ts.append(prev + float(rng.exponential(mean)))
        return ts

    def available(self, client: int, t: float) -> bool:
        ts = self._extend(client, t)
        return int(np.searchsorted(ts, t, side="right")) % 2 == 0

    def next_offline(self, client: int, t0: float, t1: float,
                     ) -> Optional[float]:
        """First on->off transition in (t0, t1), or None — the dropout time
        of a client dispatched at t0 and due back at t1. The interval is
        open at t1: a client that finishes the instant it would go offline
        delivers its update (the ARRIVAL-beats-DROPOUT tie-break)."""
        ts = self._extend(client, t1)
        k = int(np.searchsorted(ts, t0, side="right"))
        if k % 2 == 1:               # already offline at t0
            return t0
        return ts[k] if ts[k] < t1 else None

    def next_online(self, client: int, t: float) -> float:
        """Earliest time >= t at which the client is available."""
        ts = self._extend(client, t)
        k = int(np.searchsorted(ts, t, side="right"))
        return t if k % 2 == 0 else ts[k]
