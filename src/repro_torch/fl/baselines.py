"""Baselines: FedAvg, FedProx, pFedMe, FedDdrl (paper §V.B) + ablations.

All share the latency/simulation substrate so straggling-latency and
training-time comparisons are apples-to-apples with HAPFL:
  FedAvg  — one global model (uniform arch), uniform intensity, param mean.
  FedProx — FedAvg + proximal term (mu) in the client loss.
  pFedMe  — personalized: client keeps a personal model trained with a
            Moreau-envelope-style proximal pull to the global model.
  FedDdrl — DRL (our PPO2) adjusts per-client local epochs + early
            termination of the slowest client's surplus epochs; fixed arch.
Ablations (paper Fig. 25): HAPFL with fixed size / fixed intensity are run
via HAPFLServer(use_ppo1=False) / (use_ppo2=False).

A round's clients train as one stacked cohort on `device` (CUDA unless the
caller asks for the CPU): one batched step of `models.cnn.apply_cnn_fast`
per local step through `fl.batched.make_batched_trainer`, the engine of the
HAPFL path, where the reference scans one client at a time. Each client's
batches are drawn from its own loader exactly as the reference draws them,
so the host data is byte-identical; FedDdrl's ragged step counts are
padded to a power of two and masked, and a masked step leaves a client's
params and momentum untouched. The selection, latency and early
termination are the reference's host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import fedavg_aggregate
from repro_torch.core.distill import make_single_train_fns
from repro_torch.core.intensity import IntensityAllocator
from repro_torch.core.latency import straggling_latency
from repro_torch.fl.batched import make_batched_trainer, next_pow2
from repro_torch.fl.env import FLEnvironment
from repro_torch.models.cnn import apply_cnn_fast, init_cnn
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


@dataclass
class BaselineRecord:
    round_idx: int
    straggling: float
    wall_time: float
    acc_global: float
    client_acc: Dict[int, float]
    latency_only: bool = False


class BaselineRunner:
    """algo in {"fedavg", "fedprox", "pfedme", "fedddrl"}; params and the
    PPO2 agent live on `device` (CUDA when None)."""

    def __init__(self, env: FLEnvironment, algo: str, seed: int = 0,
                 size: str = None, prox_mu: float = 0.1, device=None):
        self.env, self.algo = env, algo
        self.device = resolve_device(device)
        cfg = env.cfg
        self.size = size or list(env.pool)[0]
        self.cnn_cfg = env.pool[self.size]
        mu = {"fedprox": prox_mu, "pfedme": 15.0 * cfg.lr}.get(algo, 0.0)
        raw_step, init_opt = make_single_train_fns(
            lambda p, x: apply_cnn_fast(p, self.cnn_cfg, x), lr=cfg.lr,
            prox_mu=mu)
        self._train = make_batched_trainer(raw_step, init_opt)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.global_params = init_cnn(self.gen, self.cnn_cfg, self.device)
        self.personal = ({i: self.global_params for i in range(cfg.n_clients)}
                         if algo == "pfedme" else None)
        self.intensity = (IntensityAllocator(
            cfg.k_per_round, self.gen,
            total_intensity=cfg.default_epochs * cfg.k_per_round,
            device=self.device) if algo == "fedddrl" else None)
        self.history: List[BaselineRecord] = []
        self._round = 0

    def _train_cohort(self, clients: Sequence[int],
                      intensities: Sequence[int],
                      starts: List[Dict]) -> List[Dict]:
        """Every listed client's local training from its start params, one
        stacked cohort per loader batch size. Returns per-client params
        aligned with `clients`, each leaf a view of its cohort's stacked
        tensor."""
        env = self.env
        steps = [int(e) * env.cfg.batches_per_epoch for e in intensities]
        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(clients):
            groups.setdefault(env.loaders[c].batch_size, []).append(i)
        out: List = [None] * len(clients)
        for idx in groups.values():
            n = [steps[i] for i in idx]
            # pow2 padding + masking for fedddrl's varying intensities, as
            # the reference pads them; the other baselines train a constant
            # epoch count
            S = next_pow2(max(n)) if self.algo == "fedddrl" else max(n)
            xs, ys, mask = env.prefetch_round([clients[i] for i in idx], n,
                                              pad_to=S)
            stacked = tree_map(lambda *ps: torch.stack(ps),
                               *[starts[i] for i in idx])
            trained = self._train(
                stacked, torch.from_numpy(xs).to(self.device),
                torch.from_numpy(ys.astype(np.int64)).to(self.device),
                torch.from_numpy(mask).to(self.device), self.global_params)
            for j, i in enumerate(idx):
                out[i] = tree_map(lambda a, j=j: a[j], trained)
        return out

    def run_round(self, latency_only: bool = False) -> BaselineRecord:
        """One baseline round. latency_only skips CNN training, evaluation
        and aggregation (straggling/wall-time benchmarking — the latency
        figures only need the scheduling decisions, not the models)."""
        env, cfg = self.env, self.env.cfg
        r = self._round
        clients = env.select_clients()
        assess = [env.latency.assessment_time(env.profiles[c], r)
                  for c in clients]
        if self.algo == "fedddrl":
            intensities, _ = self.intensity.assign(
                self.gen, (np.asarray(assess) / min(assess)).tolist())
            # early client termination: cap the slowest client's epochs
            t_pred = [env.latency.local_train_time(env.profiles[c], r,
                                                   self.size, e,
                                                   include_lite=False)
                      for c, e in zip(clients, intensities)]
            worst = int(np.argmax(t_pred))
            intensities[worst] = max(1, intensities[worst] // 2)
        else:
            intensities = [cfg.default_epochs] * len(clients)

        local_times = [env.latency.local_train_time(env.profiles[c], r,
                                                    self.size, e,
                                                    include_lite=False)
                       for c, e in zip(clients, intensities)]
        client_acc = {}
        if not latency_only:
            starts = ([self.personal[c] for c in clients]
                      if self.algo == "pfedme"
                      else [self.global_params] * len(clients))
            client_params = self._train_cohort(clients, intensities, starts)
            for c, p in zip(clients, client_params):
                if self.algo == "pfedme":
                    self.personal[c] = p
                client_acc[c] = env.client_test_accuracy(p, self.cnn_cfg, c)
            sizes = [len(env.partitions[c]) for c in clients]
            self.global_params = fedavg_aggregate(client_params, sizes)
        if self.algo == "fedddrl":
            self.intensity.feedback(local_times)

        rec = BaselineRecord(
            round_idx=r, straggling=straggling_latency(local_times),
            wall_time=max(a + t for a, t in zip(assess, local_times)),
            acc_global=(0.0 if latency_only else
                        env.test_accuracy(self.global_params, self.cnn_cfg)),
            client_acc=client_acc, latency_only=latency_only)
        self.history.append(rec)
        self._round += 1
        return rec

    def run(self, rounds: int, verbose: bool = False) -> List[BaselineRecord]:
        for _ in range(rounds):
            rec = self.run_round()
            if verbose:
                print(f"[{self.algo}] round {rec.round_idx:3d} "
                      f"stragg={rec.straggling:8.2f} acc={rec.acc_global:.3f}")
        return self.history

    def summary(self) -> Dict[str, float]:
        # latency_only rounds train/evaluate nothing — accuracy stats must
        # come from real rounds only (mirrors HAPFLServer.summary)
        h = [r for r in self.history if not r.latency_only] or self.history
        warm = h[len(h) // 3:] or h
        out = {
            "mean_straggling": float(np.mean([r.straggling for r in warm])),
            "total_time": float(np.sum([r.wall_time for r in h])),
            "final_acc": h[-1].acc_global,
        }
        if self.algo == "pfedme":
            accs = [list(r.client_acc.values()) for r in h[-5:]]
            flat = [a for row in accs for a in row]
            if flat:
                out["personal_acc_mean"] = float(np.mean(flat))
                out["personal_acc_max"] = float(np.max(flat))
        return out
