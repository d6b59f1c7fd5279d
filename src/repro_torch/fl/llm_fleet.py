"""HAPFL over a fleet of TRANSFORMER clients: the paper's technique driving
the assigned architectures end to end, at the reference's smoke scale.

Counterpart of ``repro.fl.llm_fleet``. Each client trains a size variant of
one assigned arch family together with the shared LiteModel via mutual KD
(Eqs. 33-35, `train/step.py`); PPO1 picks the variant, PPO2 the number of
local steps; aggregation is entropy+accuracy weighted per size group (Eqs.
36-39). Non-IID-ness comes from per-client Zipf token streams, drawn with
numpy as the reference draws them, so they are the reference's bit for bit.

The training step updates its state in place, so each client starts from
its own copy of its size's globals, the shared LiteModel and a fresh AdamW
state: the reference hands every client the same (immutable) arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.aggregation import (aggregation_weights,
                                          group_aggregate,
                                          information_entropy,
                                          weighted_aggregate)
from repro_torch.core.allocation import ModelAllocator
from repro_torch.core.intensity import IntensityAllocator
from repro_torch.core.latency import (LatencyModel,
                                      make_heterogeneous_clients,
                                      straggling_latency)
from repro_torch.models.transformer import apply_model
from repro_torch.optim import adamw
from repro_torch.train.step import (TrainStepConfig, make_hapfl_train_step,
                                    make_train_state)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


@dataclass
class FleetConfig:
    arch: str = "llama3.2-3b"
    n_clients: int = 6
    k_per_round: int = 4
    max_speed_ratio: float = 8.0
    seq: int = 64
    batch: int = 4
    default_steps: int = 4       # per-round local steps baseline
    lr: float = 1e-2
    seed: int = 0


class LLMFleet:
    def __init__(self, cfg: FleetConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        base = get_config(cfg.arch).smoke()
        small = dataclasses.replace(base, name=f"{base.name}-s", n_layers=1,
                                    d_ff=max(base.d_ff // 2, 128) if base.d_ff
                                    else 0)
        self.pool = {"small": small, "large": base}
        self.lite = dataclasses.replace(base.lite(), dtype=torch.float32,
                                        remat=False, scan_layers=False,
                                        vocab_size=base.vocab_size)
        self.gen = torch.Generator(self.device).manual_seed(cfg.seed)
        tcfg = TrainStepConfig(lr=cfg.lr)
        self.tcfg = tcfg
        # global params per size + shared lite (lite params tracked separately)
        templates = {s: make_train_state(self.gen, c, self.lite, tcfg,
                                         self.device)
                     for s, c in self.pool.items()}
        self.global_by_size = {s: templates[s]["params"]["local"]
                               for s in self.pool}
        self.lite_params = templates["small"]["params"]["lite"]
        self._steps = {s: make_hapfl_train_step(c, self.lite, tcfg)
                       for s, c in self.pool.items()}
        # every client's AdamW state starts at zero, as the reference's
        # template state does
        self._opt = adamw(tcfg.lr, weight_decay=tcfg.weight_decay)
        # client data: per-client Zipf token streams (non-IID exponents)
        rng = np.random.default_rng(cfg.seed)
        V = base.vocab_size
        self.client_tokens = []
        self.entropies = []
        for i in range(cfg.n_clients):
            a = rng.uniform(1.0, 1.8)
            p = 1.0 / np.arange(1, V + 1) ** a
            p /= p.sum()
            toks = rng.choice(V, size=20_000, p=p).astype(np.int32)
            self.client_tokens.append(toks)
            hist = np.bincount(toks, minlength=V)
            self.entropies.append(information_entropy(hist))
        self.profiles = make_heterogeneous_clients(
            cfg.n_clients, cfg.max_speed_ratio,
            [len(t) for t in self.client_tokens], seed=cfg.seed)
        self.latency = LatencyModel(
            {s: float(c.num_params()) for s, c in self.pool.items()},
            float(self.lite.num_params()), cost_scale=1e-9, seed=cfg.seed)
        self.allocator = ModelAllocator(cfg.k_per_round, list(self.pool),
                                        self.gen, device=self.device)
        self.intensity = IntensityAllocator(
            cfg.k_per_round, self.gen,
            total_intensity=cfg.default_steps * cfg.k_per_round,
            device=self.device)
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._round = 0
        self.history: List[Dict] = []

    # ------------------------------------------------------------------ #
    def _batch(self, client: int):
        toks = self.client_tokens[client]
        cfg = self.cfg
        i = self.rng.integers(0, len(toks) - cfg.batch * (cfg.seq + 1) - 1)
        chunk = toks[i:i + cfg.batch * (cfg.seq + 1)].reshape(
            cfg.batch, cfg.seq + 1)
        return {"tokens": torch.as_tensor(chunk[:, :-1], device=self.device),
                "labels": torch.as_tensor(chunk[:, 1:], device=self.device)}

    def _next_token_acc(self, params, model_cfg, client: int) -> float:
        b = self._batch(client)
        with torch.no_grad():
            logits, _, _ = apply_model(params, model_cfg, b)
        pred = logits.argmax(-1)
        return float((pred == b["labels"]).float().mean())

    def run_round(self) -> Dict:
        cfg = self.cfg
        r = self._round
        clients = sorted(self.rng.choice(cfg.n_clients, cfg.k_per_round,
                                         replace=False).tolist())
        assess = [self.latency.assessment_time(self.profiles[c], r)
                  for c in clients]
        sizes, _ = self.allocator.allocate(self.gen, assess)
        modified = [self.latency.relative_time_ratio(s) * t / min(assess)
                    for s, t in zip(sizes, assess)]
        taus, _ = self.intensity.assign(self.gen, modified)

        local_times, params_out, accs_local, accs_lite = [], [], [], []
        for c, s, tau in zip(clients, sizes, taus):
            local_times.append(self.latency.local_train_time(
                self.profiles[c], r, s, tau))
            params = tree_map(torch.clone,
                              {"local": self.global_by_size[s],
                               "lite": self.lite_params})
            state = {"params": params, "opt": self._opt.init(params)}
            step = self._steps[s]
            for _ in range(int(tau)):
                state, metrics = step(state, self._batch(c))
            params_out.append(state["params"])
            accs_local.append(self._next_token_acc(state["params"]["local"],
                                                   self.pool[s], c))
            accs_lite.append(self._next_token_acc(state["params"]["lite"],
                                                  self.lite, c))
        ents = [self.entropies[c] for c in clients]
        self.lite_params = weighted_aggregate(
            self.lite_params, [p["lite"] for p in params_out],
            aggregation_weights(ents, accs_lite))
        self.global_by_size = group_aggregate(
            self.global_by_size, [p["local"] for p in params_out], sizes,
            ents, accs_local)
        self.allocator.feedback(local_times, taus)
        self.intensity.feedback(local_times)
        rec = {"round": r, "clients": clients, "sizes": sizes, "taus": taus,
               "straggling": straggling_latency(local_times),
               "acc_local_mean": float(np.mean(accs_local)),
               "acc_lite_mean": float(np.mean(accs_lite))}
        self.history.append(rec)
        self._round += 1
        return rec

