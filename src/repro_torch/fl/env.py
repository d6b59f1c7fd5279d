"""FL simulation environment: data, clients, latency, model pools.

Mirrors the paper's testbed (§V.A): K heterogeneous clients, Dirichlet(0.4)
non-IID data, a LiteModel + {small[, medium], large} CNN pool, and an
analytic latency model with time-varying client speeds. Data, partitions,
loaders and latency are host numpy, identical to the reference's; accuracy
is evaluated in chunks on the device that holds the params.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.latency import LatencyModel, make_heterogeneous_clients
from repro_torch.core.aggregation import information_entropy
from repro_torch.core.population import ClientStore
from repro_torch.data import (BatchLoader, dirichlet_partition,
                              label_histogram, make_image_dataset,
                              prefetch_steps)
from repro_torch.models.cnn import CNNConfig, apply_cnn, cnn_pool
from repro_torch.utils.pytree import tree_leaves


@dataclass
class FLSimConfig:
    dataset: str = "mnist"
    n_clients: int = 10          # K (paper Table II)
    k_per_round: int = 6         # k
    max_speed_ratio: float = 10.0
    size_names: Tuple[str, ...] = ("small", "large")
    default_epochs: int = 20     # E (paper Table II)
    batch_size: int = 32
    batches_per_epoch: int = 2   # CPU-budget knob: batches per "epoch"
    # paper lr3=3e-4 (Adam, real data); tuned for SGD-momentum + synthetic data
    lr: float = 5e-3
    dirichlet_alpha: float = 0.4
    n_train: int = 3000
    n_test: int = 600
    seed: int = 0
    md: float = 10.0             # MD (paper Table II)


def _select_clients(rng: np.random.Generator, n_clients: int, k_default: int,
                    k: Optional[int], among) -> List[int]:
    """Shared participant draw (FLEnvironment + PopulationEnv): sorted
    sample of k without replacement, optionally restricted to `among`."""
    kk = k_default if k is None else k
    if among is None:
        return sorted(rng.choice(n_clients, size=min(kk, n_clients),
                                 replace=False).tolist())
    pool = np.sort(np.asarray(among))
    kk = min(kk, len(pool))
    if kk == 0:
        return []
    return sorted(rng.choice(pool, size=kk, replace=False).tolist())


class FLEnvironment:
    def __init__(self, cfg: FLSimConfig):
        self.cfg = cfg
        data = make_image_dataset(cfg.dataset, cfg.n_train, cfg.n_test,
                                  seed=1234 + cfg.seed)
        self.data = data
        self.n_classes = data["n_classes"]
        parts = dirichlet_partition(data["y_train"], cfg.n_clients,
                                    cfg.dirichlet_alpha, seed=cfg.seed)
        self.partitions = parts
        self.histograms = [label_histogram(data["y_train"], p, self.n_classes)
                           for p in parts]
        self.entropies = [information_entropy(h) for h in self.histograms]
        self.loaders = [
            BatchLoader(data["x_train"][p], data["y_train"][p],
                        cfg.batch_size, seed=cfg.seed + 7 * i)
            for i, p in enumerate(parts)]
        # model pool
        pool = cnn_pool(cfg.dataset)
        self.pool: Dict[str, CNNConfig] = {s: pool[s] for s in cfg.size_names}
        self.lite_cfg: CNNConfig = pool["lite"]
        # latency model (cost ~ analytic parameter count)
        self.latency = LatencyModel(
            {s: float(c.num_params()) for s, c in self.pool.items()},
            float(self.lite_cfg.num_params()), seed=cfg.seed)
        self.profiles = make_heterogeneous_clients(
            cfg.n_clients, cfg.max_speed_ratio,
            [len(p) for p in parts], seed=cfg.seed)
        # struct-of-arrays mirror of the per-client state (DESIGN.md §15);
        # the server routes latency queries through it vectorized
        self.store = ClientStore.from_profiles(
            self.profiles, self.entropies, size_names=cfg.size_names)
        self.rng = np.random.default_rng(cfg.seed + 99)
        self._device_data: Dict[str, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------------ #
    def prefetch_round(self, clients: Sequence[int],
                       steps_per_client: Sequence[int], pad_to: int = None,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pre-sample each listed client's step batches into stacked
        (clients, steps, ...) arrays + step mask (the batched engine's data
        path). Advances each loader's rng exactly as per-step sampling would."""
        return prefetch_steps(self.loaders, clients, steps_per_client,
                              pad_to=pad_to)

    def select_clients(self, k: int = None, among: Sequence[int] = None,
                       ) -> List[int]:
        """Sample k participants. `among` restricts the pool (the event
        scheduler excludes in-flight / offline clients); None keeps the
        legacy full-pool draw byte-identical."""
        return _select_clients(self.rng, self.cfg.n_clients,
                               self.cfg.k_per_round, k, among)

    def _on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The dataset's arrays as tensors on `device`, copied once."""
        key = str(device)
        if key not in self._device_data:
            self._device_data[key] = {
                k: torch.from_numpy(self.data[k]).to(device)
                for k in ("x_train", "y_train", "x_test", "y_test")}
        return self._device_data[key]

    @staticmethod
    @torch.no_grad()
    def _chunked_accuracy(params, cnn_cfg: CNNConfig, x: torch.Tensor,
                          y: torch.Tensor, chunk: int) -> float:
        """Full-set accuracy in chunks of `chunk` rows on x's device."""
        correct = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, len(x), chunk):
            pred = apply_cnn(params, cnn_cfg, x[i:i + chunk]).argmax(-1)
            correct += (pred == y[i:i + chunk]).sum()
        return int(correct) / len(x)

    def test_accuracy(self, params, cnn_cfg: CNNConfig,
                      chunk: int = 512) -> float:
        d = self._on(tree_leaves(params)[0].device)
        return self._chunked_accuracy(params, cnn_cfg, d["x_test"],
                                      d["y_test"], chunk)

    def client_test_accuracy(self, params, cnn_cfg: CNNConfig,
                             client: int, chunk: int = 256) -> float:
        """Accuracy on the client's own label distribution (personalized)."""
        d = self._on(tree_leaves(params)[0].device)
        idx = torch.from_numpy(self.partitions[client]).to(
            d["x_train"].device)
        return self._chunked_accuracy(params, cnn_cfg, d["x_train"][idx],
                                      d["y_train"][idx], chunk)


class PopulationEnv:
    """Latency/availability-only environment for population-scale
    simulation (DESIGN.md §15). Per-client state lives entirely in a
    struct-of-arrays ClientStore — no datasets, loaders, or ClientProfile
    objects are ever built, so a 100k-client environment costs megabytes
    and constructs in milliseconds. Drives `HAPFLServer` through the same
    wave callbacks as `FLEnvironment`, but only in latency_only mode
    (plan -> PPO decisions -> feedback; no CNN training or accuracy
    evaluation): pair with ``EventScheduler(latency_only=True,
    eval_accuracy=False)`` or a ``ParamService``. The server reads every
    latency query from the store, so no profile objects are needed."""

    def __init__(self, cfg: FLSimConfig, mean_dataset_size: int = 300):
        self.cfg = cfg
        pool = cnn_pool(cfg.dataset)
        self.pool: Dict[str, CNNConfig] = {s: pool[s] for s in cfg.size_names}
        self.lite_cfg: CNNConfig = pool["lite"]
        self.latency = LatencyModel(
            {s: float(c.num_params()) for s, c in self.pool.items()},
            float(self.lite_cfg.num_params()), seed=cfg.seed)
        self.store = ClientStore.synthetic(
            cfg.n_clients, cfg.max_speed_ratio,
            mean_dataset_size=mean_dataset_size, seed=cfg.seed,
            size_names=cfg.size_names)
        self.entropies = self.store.entropy
        self.rng = np.random.default_rng(cfg.seed + 99)

    def select_clients(self, k: int = None, among: Sequence[int] = None,
                       ) -> List[int]:
        return _select_clients(self.rng, self.cfg.n_clients,
                               self.cfg.k_per_round, k, among)
