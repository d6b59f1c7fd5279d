"""Per-wave PPO diagnostics for both HAPFL agents (DESIGN.md §16).

The PPO agents only *update* every `buffer_size` waves (paper B = 5), so
per-wave diagnostics mix two sources:

  every wave       policy entropy at the wave's acted state (one forward
                   through the actor under no_grad — no random numbers
                   drawn, so collecting it never perturbs the simulation),
                   the wave's reward, and the buffer fill level;
  every update     the optimizer-side metrics `_ppo_update` computes
                   anyway: approx-KL vs the behaviour policy, clip
                   fraction, pre-normalization advantage mean/std, value
                   loss — carried forward on `PPOAgent.last_update` until
                   the next update replaces them.

`wave_diagnostics(server)` packages both agents' views; the server emits
it as trace counters and stamps it on the round record (`rl_diag`) — only
when tracing is enabled (or a health tracker asks for it), so disabled
runs stay byte-identical to uninstrumented ones.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.ppo import PPOAgent, _policy_dist

#: last_update keys surfaced per wave (the full dict also carries
#: loss/actor_loss/critic_loss/mean_ratio/mean_return)
UPDATE_KEYS = ("approx_kl", "clip_fraction", "adv_mean", "adv_std",
               "value_loss")


@torch.no_grad()
def policy_entropy(agent: PPOAgent, state) -> float:
    """Entropy of the agent's current policy at `state` (nats; summed over
    the per-client heads for PPO1, over action dims for PPO2)."""
    cfg = agent.cfg
    dist = _policy_dist(agent.params,
                        torch.as_tensor(np.asarray(state, np.float32),
                                        device=agent.device), cfg)
    if cfg.kind == "categorical_multihead":
        logp = dist["logits"]                          # (k, delta) log-probs
        return float(-torch.sum(torch.exp(logp) * logp))
    # diagonal Gaussian: state-independent, sum over dims
    return float(torch.sum(dist["log_std"]
                           + 0.5 * math.log(2 * math.pi * math.e)))


def agent_diagnostics(owner) -> Dict[str, Optional[float]]:
    """One agent-owner's (ModelAllocator / IntensityAllocator) per-wave
    view; `_pending` holds the state the agent just acted on."""
    agent = owner.agent
    pend = getattr(owner, "_pending", None) or {}
    d: Dict[str, Optional[float]] = {
        "reward": (float(agent.reward_history[-1])
                   if agent.reward_history else None),
        "buffer_fill": float(len(agent.buffer)),
        "n_updates": float(agent.n_updates),
        "entropy": (policy_entropy(agent, pend["state"])
                    if "state" in pend else None),
    }
    last = agent.last_update
    for k in UPDATE_KEYS:
        d[k] = (round(float(last[k]), 6) if last else None)
    return d


def wave_diagnostics(server) -> Dict[str, Dict]:
    """Both agents' diagnostics for the wave whose feedback just ran."""
    out: Dict[str, Dict] = {}
    if server.use_ppo1:
        out["ppo1"] = agent_diagnostics(server.allocator)
    if server.use_ppo2:
        out["ppo2"] = agent_diagnostics(server.intensity)
    return out
