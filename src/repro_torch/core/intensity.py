"""PPO2 — RL-based training intensity adjustment (paper §IV.C.2)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ppo import PPOAgent, PPOConfig


def _softmax(v: np.ndarray) -> np.ndarray:
    e = np.exp(v - v.max())
    return e / e.sum()


class IntensityAllocator:
    """Maps PPO1-modified times -> per-client training intensities.

    State  (Eq. 24-25): T^m_i = M(a_i) * T'_i
    Action (Eq. 26-27): sigma = softmax(gaussian sample); tau = sigma * total
    Reward (Eq. 28):    min(T^l) - max(T^l)  (negative straggling latency)
    """

    def __init__(self, k: int, gen: torch.Generator,
                 total_intensity: int = None, lr: float = 3e-4,
                 buffer_size: int = 5, gamma: float = 0.3,
                 update_epochs: int = 8, device=None):
        # Paper Table II: lr2=3e-4, B=5, eps=0.2. See ModelAllocator re gamma.
        self.k = k
        self.total_intensity = total_intensity or 20 * k  # E=20 per client avg
        cfg = PPOConfig(state_dim=k, kind="gaussian_simplex", lr=lr,
                        buffer_size=buffer_size, gamma=gamma,
                        update_epochs=update_epochs)
        self.agent = PPOAgent(cfg, gen, device)
        self._pending: Dict = {}

    def assign(self, gen: torch.Generator, modified_times: Sequence[float],
               deterministic: bool = False) -> Tuple[List[int], np.ndarray]:
        # Eq. 24-25 state, in LOG scale (see ModelAllocator.normalize_state)
        m = np.asarray(modified_times, np.float64)
        state = np.log(np.maximum(m / m.min(), 1e-9)).astype(np.float32)
        action, logprob = self.agent.act(gen, state, deterministic)
        sigma = _softmax(np.asarray(action, np.float64))          # Eq. 26
        tau = np.maximum(np.round(sigma * self.total_intensity), 1)  # Eq. 27+13
        self._pending = {"state": state, "action": action, "logprob": logprob}
        return [int(t) for t in tau], sigma

    def feedback(self, local_times: Sequence[float]) -> float:
        t = np.asarray(local_times, np.float64)
        reward = float(t.min() - t.max())                          # Eq. 28
        self.agent.store(self._pending["state"], self._pending["action"],
                         self._pending["logprob"], reward)
        self.agent.maybe_update()
        return reward
