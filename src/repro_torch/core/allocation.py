"""PPO1 — RL-based heterogeneous model allocation (paper §IV.C.1)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ppo import PPOAgent, PPOConfig


class ModelAllocator:
    """Maps assessment times -> per-client model size category.

    State  (Eq. 16-17): T'_i = T^d_i / min(T^d)
    Action (Eq. 18-19): category in {0..delta-1} per client
    Reward (Eq. 23):    MD - max(T^l_avg)/min(T^l_avg)
    """

    def __init__(self, k: int, size_names: Sequence[str],
                 gen: torch.Generator, md: float = 10.0, lr: float = 0.02,
                 buffer_size: int = 5, gamma: float = 0.3,
                 update_epochs: int = 8, device=None):
        # Paper Table II: lr1=0.02, B=5, eps=0.2. gamma/epochs are ours: the
        # FL round is contextual-bandit-like (speeds evolve exogenously), so
        # a small discount cuts credit-assignment variance markedly.
        self.size_names = list(size_names)
        self.md = md
        cfg = PPOConfig(state_dim=k, kind="categorical_multihead",
                        n_categories=len(size_names), lr=lr,
                        buffer_size=buffer_size, gamma=gamma,
                        update_epochs=update_epochs, entropy_coef=0.003)
        self.agent = PPOAgent(cfg, gen, device)
        self._pending: Dict = {}

    @staticmethod
    def normalize_state(assess_times: Sequence[float]) -> np.ndarray:
        """Eq. 16 ratio, in LOG scale: raw ratios reach 50x (paper's own
        scalability setup) and saturate the tanh MLP; log keeps the state in
        [0, ~4] and fixed the 20/100-client scalability runs (DESIGN.md §8)."""
        t = np.asarray(assess_times, np.float64)
        return np.log(np.maximum(t / t.min(), 1e-9)).astype(np.float32)

    def allocate(self, gen: torch.Generator, assess_times: Sequence[float],
                 deterministic: bool = False) -> Tuple[List[str], np.ndarray]:
        state = self.normalize_state(assess_times)
        action, logprob = self.agent.act(gen, state, deterministic)
        self._pending = {"state": state, "action": action, "logprob": logprob}
        # Intuition (paper): slower client (larger T') -> smaller model.
        return [self.size_names[int(a)] for a in action], action

    def feedback(self, local_times: Sequence[float],
                 intensities: Sequence[float]) -> float:
        """Reward from this round's measured per-epoch times (Eqs. 20-23)."""
        t = np.asarray(local_times, np.float64)
        tau = np.maximum(np.asarray(intensities, np.float64), 1.0)
        t_avg = t / tau
        reward = self.md - t_avg.max() / max(t_avg.min(), 1e-9)
        self.agent.store(self._pending["state"], self._pending["action"],
                         self._pending["logprob"], reward)
        self.agent.maybe_update()
        return float(reward)
