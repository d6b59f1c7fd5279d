"""HAPFL server — Algorithm 1 end-to-end over the CNN FL simulation.

Per round: assessment training -> PPO1 model allocation -> PPO2 intensity
assignment -> client mutual-KD local training -> entropy+accuracy weighted
aggregation (LiteModels globally; local models per size group, or
cross-size nested with ``aggregation="cross_size"`` — DESIGN.md §12) ->
RL rewards and buffered PPO updates.

The round body is factored into the reference's wave-level callbacks
(`plan_wave`, `train_wave`, `wave_updates`, `apply_updates`,
`feedback_wave`, `record_wave`), which the event-driven simulator
(`repro_torch.sim`) drives on arbitrary client subsets at arbitrary
virtual times; `run_round` composes them into the synchronous barrier
round. Params, PPO agents and training live on `device` (CUDA unless the
caller asks for the CPU); data, client selection, latency and the update
codecs' wire format are host numpy, identical to the reference's. Under
``engine="sharded"`` (or a ``mesh=``) every rank of the mesh runs this
server from the same seed and trains its slice of each cohort
(`fl/sharded.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import make_codec
from repro_torch.core.allocation import ModelAllocator
from repro_torch.core.aggregation import (fedavg_aggregate, group_aggregate,
                                          staleness_weights,
                                          weighted_aggregate)
from repro_torch.core.intensity import IntensityAllocator
from repro_torch.core.latency import straggling_latency
from repro_torch.core.nested import nested_aggregate
from repro_torch.fl.batched import BatchedClientEngine
from repro_torch.fl.env import FLEnvironment
from repro_torch.fl.sharded import ShardedClientEngine
from repro_torch.models.cnn import init_cnn
from repro_torch.obs.rl import wave_diagnostics
from repro_torch.obs.trace import current as _tracer
from repro_torch.utils.device import resolve_device


@dataclass
class RoundRecord:
    round_idx: int
    clients: List[int]
    sizes: List[str]
    intensities: List[int]
    assess_times: List[float]
    local_times: List[float]
    straggling: float
    wall_time: float
    reward_ppo1: float
    reward_ppo2: float
    acc_lite: float
    acc_by_size: Dict[str, float]
    client_acc: Dict[int, Dict[str, float]]
    latency_only: bool = False
    #: per-wave PPO diagnostics (repro_torch.obs.rl) — populated only when
    #: tracing is enabled (or a health tracker sets `collect_rl_diag`),
    #: None otherwise, so untraced runs stay byte-identical to
    #: uninstrumented ones
    rl_diag: Optional[Dict[str, Dict]] = None


@dataclass
class WavePlan:
    """One dispatched cohort: the RL decisions plus (simulated) per-client
    times, filled in by `plan_wave` and `train_wave`. `version` is the
    server aggregation count at dispatch (staleness bookkeeping)."""
    round_idx: int
    clients: List[int]
    assess: List[float]
    sizes: List[str]
    intensities: List[int]
    local_times: List[float]
    latency_only: bool = False
    version: int = 0
    t_dispatch: float = 0.0
    client_params: List[Dict] = field(default_factory=list)
    accs_local: List[float] = field(default_factory=list)
    accs_lite: List[float] = field(default_factory=list)
    wire_bytes: List[float] = field(default_factory=list)  # per-client uplink


class HAPFLServer:
    def __init__(self, env: FLEnvironment, seed: int = 0,
                 use_ppo1: bool = True, use_ppo2: bool = True,
                 weighted_agg: bool = True,
                 lr_ppo1: float = 2e-3, lr_ppo2: float = 3e-4,
                 engine: str = "auto", aggregation: str = "group",
                 codec=None, mesh=None, device=None):
        # paper Table II: lr1=0.02 — unstable for Adam on our tiny actor
        # (PPO1 reward degrades); 2e-3 learns cleanly (DESIGN.md §8).
        if engine not in ("auto", "batched", "sequential", "sharded"):
            raise ValueError(f"unknown engine {engine!r}")
        # an explicit mesh selects the mesh-sharded cohort engine
        # (fl/sharded.py) unless the caller pinned another one;
        # engine="sharded" without a mesh spans the world
        if mesh is not None and engine == "auto":
            engine = "sharded"
        if mesh is not None and engine != "sharded":
            raise ValueError(f"mesh= requires engine='sharded' (got "
                             f"{engine!r})")
        self.mesh = mesh
        if aggregation not in ("group", "cross_size"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.device = resolve_device(device)
        # update codec (repro_torch.comm, DESIGN.md §13): every client
        # update is round-tripped through it before aggregation sees it.
        # None skips the round trip entirely; "identity" takes it but passes
        # the tensors through untouched — both are bit-identical.
        self.codec = None if codec is None else make_codec(codec)
        self.codec_seed = seed
        if engine == "auto":
            # on a card the batched engine wins; on the CPU keep the
            # reference's rule: batching wins at small, dispatch-bound
            # batches (DESIGN.md §9)
            engine = ("batched" if self.device.type == "cuda"
                      or env.cfg.batch_size <= 8 else "sequential")
        # struct-of-arrays per-client state (DESIGN.md §15): latency
        # queries route through it vectorized, and the scheduler mirrors
        # its in-flight slots into it
        self.store = env.store
        # error-feedback residuals, keyed (client, kind, size) — "local"
        # trees change shape when PPO1 reassigns sizes, so each (client,
        # size) pair carries its own residual; "lite" is homogeneous. The
        # store's sparse EF dict, aliased.
        self._ef: Dict = self.store.ef
        self.env = env
        self.engine = engine
        self.aggregation = aggregation
        cfg = env.cfg
        self.use_ppo1, self.use_ppo2 = use_ppo1, use_ppo2
        self.weighted_agg = weighted_agg
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.allocator = ModelAllocator(cfg.k_per_round, list(env.pool),
                                        self.gen, md=cfg.md, lr=lr_ppo1,
                                        device=self.device)
        self.intensity = IntensityAllocator(
            cfg.k_per_round, self.gen,
            total_intensity=cfg.default_epochs * cfg.k_per_round, lr=lr_ppo2,
            device=self.device)
        # global models: one lite + one per size category
        self.lite_params = init_cnn(self.gen, env.lite_cfg, self.device)
        self.global_by_size = {s: init_cnn(self.gen, c, self.device)
                               for s, c in env.pool.items()}
        # one engine for both: "batched" trains a size group per step,
        # "sequential" loops over clients through the same step; "sharded"
        # splits each size group's clients over the mesh's ranks
        if engine == "sharded":
            self.batched_engine = ShardedClientEngine(
                env, mesh=mesh, lr=cfg.lr, device=self.device)
            self.mesh = self.batched_engine.mesh
        else:
            self.batched_engine = BatchedClientEngine(env, lr=cfg.lr,
                                                      device=self.device)
        self.history: List[RoundRecord] = []
        self._round = 0
        self._last_rl_diag: Optional[Dict[str, Dict]] = None
        # set by a scheduler with a FleetHealth attached: collect per-wave
        # PPO diagnostics even when tracing is off (the trace counter emits
        # stay no-ops; only RoundRecord.rl_diag fills in)
        self.collect_rl_diag = False

    # ------------------------------------------------------------------ #
    def _client_train(self, client: int, size: str, intensity: int):
        """Sequential engine: one client's steps, unpadded."""
        return self.batched_engine.train_cohort(
            [client], [size], [intensity], self.global_by_size,
            self.lite_params, pad_pow2=False, pad_clients=False)[0]

    def pretrain_rl(self, rounds: int) -> List[Dict[str, float]]:
        """Latency-only rounds to train the PPO agents (Algorithm 1 runs
        E episodes x R rounds; rewards depend only on the latency model, so
        no CNN training is needed to learn the policies)."""
        out = []
        for _ in range(rounds):
            rec = self.run_round(latency_only=True)
            out.append({"reward_ppo1": rec.reward_ppo1,
                        "reward_ppo2": rec.reward_ppo2,
                        "straggling": rec.straggling})
        return out

    # ------------------------------------------------------------------ #
    # wave-level callbacks (driven by run_round and by repro_torch.sim)
    # ------------------------------------------------------------------ #
    def _pad(self, vals: Sequence):
        """Pad a per-client list to the PPO state dim k by repeating the
        first element (a sub-k wave leaves every max/min/ratio statistic
        the agents' states and rewards use unchanged)."""
        k = self.env.cfg.k_per_round
        return list(vals) + [vals[0]] * (k - len(vals))

    def plan_wave(self, clients: Optional[Sequence[int]] = None,
                  latency_only: bool = False,
                  deterministic: bool = False) -> WavePlan:
        """Algorithm-1 steps 1-3 for one cohort: selection, assessment
        times, PPO1 size allocation, PPO2 intensities, simulated local
        times."""
        with _tracer().span("server.plan_wave", round=self._round,
                            latency_only=latency_only):
            return self._plan_wave(clients, latency_only, deterministic)

    def _plan_wave(self, clients, latency_only, deterministic) -> WavePlan:
        env, cfg = self.env, self.env.cfg
        r = self._round
        self._round += 1
        if clients is None:
            clients = env.select_clients()
        clients = [int(c) for c in clients]
        m = len(clients)
        # 1. performance assessment training (one Lite epoch, simulated)
        assess = [float(a) for a in
                  env.latency.assessment_times(self.store, clients, r)]
        # 2. PPO1: model allocation
        if self.use_ppo1:
            sizes, _ = self.allocator.allocate(self.gen, self._pad(assess),
                                               deterministic)
            sizes = sizes[:m]
        else:
            sizes = [list(env.pool)[0]] * m
        # 3. PPO2: training intensities
        pad_assess = self._pad(assess)
        norm = np.asarray(pad_assess) / min(pad_assess)
        modified = [env.latency.relative_time_ratio(s) * t
                    for s, t in zip(self._pad(sizes), norm)]
        if self.use_ppo2:
            intensities, _ = self.intensity.assign(self.gen, modified,
                                                   deterministic)
            intensities = intensities[:m]
        else:
            intensities = [cfg.default_epochs] * m
        local_times = [float(t) for t in env.latency.local_train_times(
            self.store, clients, r, sizes, intensities)]
        self.store.note_plan(clients, assess, local_times, sizes, intensities)
        return WavePlan(round_idx=r, clients=clients, assess=assess,
                        sizes=sizes, intensities=list(intensities),
                        local_times=local_times, latency_only=latency_only)

    def train_wave(self, plan: WavePlan, eval_accuracy: bool = True,
                   ) -> WavePlan:
        """Step 4: real mutual-KD training from the current globals, grouped
        into per-size cohorts by the batched engine."""
        with _tracer().span("server.train_wave", round=plan.round_idx,
                            n=len(plan.clients),
                            latency_only=plan.latency_only):
            return self._train_wave(plan, eval_accuracy)

    def _train_wave(self, plan: WavePlan, eval_accuracy: bool) -> WavePlan:
        env = self.env
        m = len(plan.clients)
        if plan.latency_only:
            plan.client_params = []
            plan.accs_local = [0.0] * m
            plan.accs_lite = [0.0] * m
            return plan
        if self.engine in ("batched", "sharded"):
            plan.client_params = self.batched_engine.train_cohort(
                plan.clients, plan.sizes, plan.intensities,
                self.global_by_size, self.lite_params)
        else:
            plan.client_params = [
                self._client_train(c, s, tau)
                for c, s, tau in zip(plan.clients, plan.sizes,
                                     plan.intensities)]
        self._encode_wave(plan)
        if eval_accuracy:
            plan.accs_local = [
                env.client_test_accuracy(p["local"], env.pool[s], c)
                for p, s, c in zip(plan.client_params, plan.sizes,
                                   plan.clients)]
            plan.accs_lite = [
                env.client_test_accuracy(p["lite"], env.lite_cfg, c)
                for p, c in zip(plan.client_params, plan.clients)]
        else:
            plan.accs_local = [0.0] * m
            plan.accs_lite = [0.0] * m
        return plan

    def _encode_wave(self, plan: WavePlan) -> None:
        """Round-trip the wave's trained params through the update codec:
        encode each client's {local, lite} delta against the dispatch-time
        globals (train_wave runs at dispatch, so the current globals ARE
        the reference the client trained from), decode immediately, and
        replace `plan.client_params` with the wire-faithful result — every
        downstream consumer (accuracy eval, apply_updates, group or
        cross_size) then sees exactly what survived the wire.
        Error-feedback residuals persist in self._ef across rounds;
        per-client wire bytes land in plan.wire_bytes."""
        if self.codec is None or not plan.client_params:
            return
        with _tracer().span("server.encode_wave", round=plan.round_idx,
                            n=len(plan.clients), codec=self.codec.name):
            self._encode_wave_impl(plan)

    def _encode_wave_impl(self, plan: WavePlan) -> None:
        codec, wire = self.codec, []
        for i, c in enumerate(plan.clients):
            size = plan.sizes[i]
            refs = (("local", size, self.global_by_size[size]),
                    ("lite", "", self.lite_params))
            dec, total = {}, 0.0
            for kind, sz, ref in refs:
                key = (c, kind, sz)
                enc, state = codec.encode(
                    plan.client_params[i][kind], ref, self._ef.get(key),
                    seed=self.codec_seed, client=c,
                    round_idx=plan.round_idx, tag=kind)
                if state is not None:
                    self._ef[key] = state
                dec[kind] = codec.decode(enc, ref)
                total += enc.wire_bytes
            plan.client_params[i] = dec
            wire.append(total)
        plan.wire_bytes = wire

    def wave_updates(self, plan: WavePlan,
                     indices: Optional[Sequence[int]] = None,
                     staleness: Optional[int] = None) -> List[Dict]:
        """Package (a subset of) a trained wave as update dicts for
        `apply_updates`. `staleness` tags every listed update."""
        idx = range(len(plan.clients)) if indices is None else indices
        return [{"client": plan.clients[i], "size": plan.sizes[i],
                 "params": plan.client_params[i],
                 "entropy": self.env.entropies[plan.clients[i]],
                 "acc_local": plan.accs_local[i],
                 "acc_lite": plan.accs_lite[i],
                 "staleness": staleness} for i in idx]

    def _aggregate_local(self, locals_, sizes, ents, accs, stal,
                         staleness_exponent, mix):
        """Route the heterogeneous-model aggregation: per-size-group (Eq. 5)
        or cross-size nested (HeteroFL-style coverage-weighted, DESIGN.md
        §12). Both consume the same staleness tags."""
        if self.aggregation == "cross_size":
            return nested_aggregate(
                self.global_by_size, self.env.pool, locals_, sizes, ents,
                accs, staleness=stal, staleness_exponent=staleness_exponent,
                mix=mix)
        return group_aggregate(
            self.global_by_size, locals_, sizes, ents, accs, staleness=stal,
            staleness_exponent=staleness_exponent, mix=mix)

    def apply_updates(self, updates: List[Dict],
                      staleness_exponent: float = 0.5,
                      mix: float = 1.0) -> int:
        """Step 5 generalized: fold client updates (possibly cross-wave,
        possibly stale) into the globals. With staleness=None on every
        update, mix=1 and aggregation="group" this is the synchronous
        aggregation."""
        if not updates:
            return 0
        with _tracer().span("server.apply_updates", n=len(updates)):
            return self._apply_updates(updates, staleness_exponent, mix)

    def _apply_updates(self, updates, staleness_exponent, mix) -> int:
        sizes = [u["size"] for u in updates]
        locals_ = [u["params"]["local"] for u in updates]
        lites = [u["params"]["lite"] for u in updates]
        stal = ([int(u["staleness"] or 0) for u in updates]
                if any(u.get("staleness") is not None for u in updates)
                else None)
        n = len(updates)
        if self.weighted_agg:
            ents = [u["entropy"] for u in updates]
            accs_lite = [u["acc_lite"] for u in updates]
            accs_local = [u["acc_local"] for u in updates]
        elif stal is None and mix == 1.0 and self.aggregation == "group":
            self.lite_params = fedavg_aggregate(lites)
            for s in set(sizes):
                self.global_by_size[s] = fedavg_aggregate(
                    [locals_[i] for i, ss in enumerate(sizes) if ss == s])
            return n
        else:
            # unweighted: uniform base weights (softmax of zeros), still
            # staleness-discounted / server-mixed / cross-size as configured
            ents = accs_lite = accs_local = [0.0] * n
        w = staleness_weights(ents, accs_lite, stal, staleness_exponent)
        self.lite_params = weighted_aggregate(self.lite_params, lites, w,
                                              mix=mix)
        self.global_by_size = self._aggregate_local(
            locals_, sizes, ents, accs_local, stal, staleness_exponent, mix)
        return n

    def feedback_wave(self, plan: WavePlan):
        """Step 6: RL rewards (Algorithm 1 lines 22-30). With tracing on
        (or `collect_rl_diag` set by a health-tracking caller), also
        collects both agents' PPO diagnostics (repro_torch.obs.rl), emits
        them as trace counters, and stages them for `record_wave`."""
        tr = _tracer()
        with tr.span("server.feedback_wave", round=plan.round_idx):
            rw1 = (self.allocator.feedback(self._pad(plan.local_times),
                                           self._pad(plan.intensities))
                   if self.use_ppo1 else 0.0)
            rw2 = (self.intensity.feedback(self._pad(plan.local_times))
                   if self.use_ppo2 else 0.0)
        if ((tr.enabled or self.collect_rl_diag)
                and (self.use_ppo1 or self.use_ppo2)):
            diag = wave_diagnostics(self)
            for agent_name, d in diag.items():
                tr.counter(f"rl.{agent_name}", d)
            tr.counter("rl.reward", {"ppo1": rw1, "ppo2": rw2})
            self._last_rl_diag = diag
        return rw1, rw2

    def record_wave(self, plan: WavePlan, rw1: float, rw2: float,
                    eval_accuracy: bool = True,
                    wall_time: Optional[float] = None) -> RoundRecord:
        """Step 7: bookkeeping. wall_time defaults to the synchronous
        barrier (max assess+local); the scheduler passes the measured
        virtual-clock span instead."""
        env = self.env
        wall = (max(a + t for a, t in zip(plan.assess, plan.local_times))
                if wall_time is None else wall_time)
        skip_eval = plan.latency_only or not eval_accuracy
        rec = RoundRecord(
            round_idx=plan.round_idx, clients=plan.clients, sizes=plan.sizes,
            intensities=[int(i) for i in plan.intensities],
            assess_times=plan.assess, local_times=plan.local_times,
            straggling=straggling_latency(plan.local_times), wall_time=wall,
            reward_ppo1=rw1, reward_ppo2=rw2,
            acc_lite=(0.0 if skip_eval else
                      env.test_accuracy(self.lite_params, env.lite_cfg)),
            acc_by_size=({s: 0.0 for s in env.pool} if skip_eval else
                         {s: env.test_accuracy(self.global_by_size[s],
                                               env.pool[s])
                          for s in env.pool}),
            client_acc={c: {"local": plan.accs_local[i],
                            "lite": plan.accs_lite[i],
                            "size": plan.sizes[i]}
                        for i, c in enumerate(plan.clients)},
            latency_only=plan.latency_only,
            rl_diag=self._last_rl_diag,
        )
        self._last_rl_diag = None
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------ #
    def run_round(self, latency_only: bool = False,
                  deterministic: bool = False,
                  eval_accuracy: bool = True) -> RoundRecord:
        """One Algorithm-1 round. eval_accuracy=False skips the global and
        per-client test-set evaluations (aggregation then weights by
        entropy + uniform accuracy)."""
        plan = self.plan_wave(latency_only=latency_only,
                              deterministic=deterministic)
        self.train_wave(plan, eval_accuracy=eval_accuracy)
        if not plan.latency_only:
            self.apply_updates(self.wave_updates(plan))
        rw1, rw2 = self.feedback_wave(plan)
        return self.record_wave(plan, rw1, rw2, eval_accuracy=eval_accuracy)

    def run(self, rounds: int, verbose: bool = False) -> List[RoundRecord]:
        for _ in range(rounds):
            rec = self.run_round()
            if verbose:
                print(f"round {rec.round_idx:3d} stragg={rec.straggling:8.2f} "
                      f"wall={rec.wall_time:8.2f} acc_lite={rec.acc_lite:.3f} "
                      f"rw1={rec.reward_ppo1:7.2f} rw2={rec.reward_ppo2:8.2f}")
        return self.history

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        # latency_only pretraining rounds train no models and would inflate
        # total_time / skew the warmup trim — stats cover real rounds only
        # (fall back to the full history when only pretraining has run).
        h = [r for r in self.history if not r.latency_only] or self.history
        warm = h[len(h) // 3:] or h   # skip RL warmup for latency stats
        return {
            "mean_straggling": float(np.mean([r.straggling for r in warm])),
            "total_time": float(np.sum([r.wall_time for r in h])),
            "final_acc_lite": h[-1].acc_lite,
            **{f"final_acc_{s}": h[-1].acc_by_size[s]
               for s in self.env.pool},
        }
