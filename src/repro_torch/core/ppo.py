"""PPO (actor-critic, clipped objective) on PyTorch — the paper's §IV.C.3.

Two policy heads are supported:
  * "categorical_multihead" — PPO1: one delta-way categorical per client
    (heterogeneous model allocation, Eq. 18-19).
  * "gaussian_simplex"      — PPO2: a Gaussian over k pre-softmax logits;
    the environment softmaxes the sampled action into the intensity simplex
    (Eq. 26). Log-probs are taken on the Gaussian.

Both agents keep an experience buffer of (state, action, logprob, reward)
and run the clipped-PPO update (Eqs. 29-32) once the buffer is full
(paper: B = 5), exactly like Algorithm 1 lines 25-30. Params keep the
reference's layout ({"w": (in, out), "b"} per MLP layer) and live on the
agent's device; sampling draws from a caller's `torch.Generator`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_add, tree_leaves, tree_map,
                                      tree_unflatten)


# --------------------------------------------------------------------- #
# tiny MLP substrate
# --------------------------------------------------------------------- #
def _mlp_init(gen: torch.Generator, sizes, device: torch.device):
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, device=gen.device) / math.sqrt(a)
        params.append({"w": w.to(device),
                       "b": torch.zeros(b, device=device)})
    return params


def _mlp_apply(params, x, final_act=None):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return final_act(x) if final_act else x


@dataclass
class PPOConfig:
    state_dim: int                    # k (clients per round)
    kind: str                         # categorical_multihead | gaussian_simplex
    n_categories: int = 3             # delta for PPO1
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    clip_eps: float = 0.2             # paper Table II
    gamma: float = 0.9
    update_epochs: int = 4
    entropy_coef: float = 0.01
    buffer_size: int = 5              # paper Table II (B)
    value_coef: float = 0.5
    init_log_std: float = -0.5


class PPOAgent:
    """Stateful wrapper: params and optimizer state on `device` (CUDA when
    None), python-side buffer."""

    def __init__(self, cfg: PPOConfig, gen: torch.Generator, device=None):
        self.cfg = cfg
        self.device = device = resolve_device(device)
        out_dim = (cfg.state_dim * cfg.n_categories
                   if cfg.kind == "categorical_multihead" else cfg.state_dim)
        self.params = {
            "actor": _mlp_init(gen, (cfg.state_dim,) + cfg.hidden + (out_dim,),
                               device),
            "critic": _mlp_init(gen, (cfg.state_dim,) + cfg.hidden + (1,),
                                device),
        }
        if cfg.kind == "gaussian_simplex":
            self.params["log_std"] = torch.full(
                (cfg.state_dim,), cfg.init_log_std, device=device)
        self.opt = adamw(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.buffer: List[Dict[str, np.ndarray]] = []
        self.reward_history: List[float] = []
        self.last_update: Optional[Dict[str, float]] = None
        self.n_updates = 0

    # ------------------------------------------------------------------ #
    def act(self, gen: torch.Generator, state: np.ndarray,
            deterministic: bool = False):
        with torch.no_grad():
            action, logprob = _act(
                self.params, gen,
                torch.as_tensor(np.asarray(state, np.float32),
                                device=self.device),
                deterministic, cfg=self.cfg)
        return action.cpu().numpy(), float(logprob)

    def store(self, state, action, logprob, reward):
        self.buffer.append({"state": np.asarray(state, np.float32),
                            "action": np.asarray(action),
                            "logprob": np.float32(logprob),
                            "reward": np.float32(reward)})
        self.reward_history.append(float(reward))

    def maybe_update(self) -> Optional[Dict[str, float]]:
        """Algorithm 1: update once the buffer is full, then clear it."""
        if len(self.buffer) < self.cfg.buffer_size:
            return None
        batch = {k: torch.as_tensor(np.stack([b[k] for b in self.buffer]),
                                    device=self.device)
                 for k in self.buffer[0]}
        self.params, self.opt_state, metrics = _ppo_update(
            self.params, self.opt_state, batch, cfg=self.cfg)
        self.buffer.clear()
        out = {k: float(v) for k, v in metrics.items()}
        self.last_update = out
        self.n_updates += 1
        return out


# --------------------------------------------------------------------- #
# functional core
# --------------------------------------------------------------------- #
def _policy_dist(params, state, cfg: PPOConfig):
    out = _mlp_apply(params["actor"], state)
    if cfg.kind == "categorical_multihead":
        logits = out.reshape(state.shape[:-1]
                             + (cfg.state_dim, cfg.n_categories))
        return {"logits": torch.log_softmax(logits, -1)}
    return {"mean": out, "log_std": params["log_std"]}


def _gaussian_logprob(action, mean, log_std):
    std = torch.exp(log_std)
    return torch.sum(-0.5 * torch.square((action - mean) / std)
                     - log_std - 0.5 * math.log(2 * math.pi), -1)


def _act(params, gen, state, deterministic, *, cfg: PPOConfig):
    dist = _policy_dist(params, state, cfg)
    if cfg.kind == "categorical_multihead":
        logp_all = dist["logits"]                       # (k, delta)
        if deterministic:
            action = torch.argmax(logp_all, -1)
        else:
            action = torch.multinomial(torch.exp(logp_all), 1,
                                       generator=gen)[..., 0]
        logprob = torch.sum(logp_all.gather(-1, action[..., None])[..., 0])
        return action, logprob
    mean, log_std = dist["mean"], dist["log_std"]
    if deterministic:
        action = mean
    else:
        eps = torch.randn(mean.shape, generator=gen, device=gen.device)
        action = mean + torch.exp(log_std) * eps.to(mean.device)
    return action, _gaussian_logprob(action, mean, log_std)


def _logprob_entropy(params, state, action, cfg: PPOConfig):
    """Batched over the leading axis of state (B, k) and action."""
    dist = _policy_dist(params, state, cfg)
    if cfg.kind == "categorical_multihead":
        logp_all = dist["logits"]                       # (B, k, delta)
        lp = torch.sum(logp_all.gather(-1, action.long()[..., None])[..., 0],
                       -1)
        ent = -torch.sum(torch.exp(logp_all) * logp_all, (-2, -1))
        return lp, ent
    mean, log_std = dist["mean"], dist["log_std"]
    lp = _gaussian_logprob(action, mean, log_std)
    ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return lp, ent.expand(lp.shape)


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """G_r = sum_t gamma^t R_{r+t} over the buffer trajectory (Eq. 29)."""
    out, g = [], torch.zeros((), dtype=rewards.dtype, device=rewards.device)
    for r in reversed(rewards.unbind(0)):
        g = r + gamma * g
        out.append(g)
    return torch.stack(out[::-1])


def _std(x):
    """Population std, as jnp.std."""
    return torch.std(x, correction=0)


def _ppo_update(params, opt_state, batch, *, cfg: PPOConfig):
    states = batch["state"]          # (B, k)
    actions = batch["action"]
    old_logprob = batch["logprob"]   # (B,)
    returns = discounted_returns(batch["reward"], cfg.gamma)
    # standardize returns per update: makes the agent invariant to the
    # reward scale (latency magnitudes differ per dataset/model pool)
    returns = (returns - returns.mean()) / (_std(returns) + 1e-6)
    # A_r = G_r - V(S_r) (Eq. 31), normalized for stability
    with torch.no_grad():
        values_old = _mlp_apply(params["critic"], states)[:, 0]
    adv_raw = returns - values_old
    adv = (adv_raw - adv_raw.mean()) / (_std(adv_raw) + 1e-6)

    def loss_fn(p):
        values = _mlp_apply(p["critic"], states)[:, 0]
        lp, ent = _logprob_entropy(p, states, actions, cfg)
        ratio = torch.exp(lp - old_logprob)                    # rho_r (Eq. 30)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        actor_loss = -torch.mean(torch.minimum(unclipped, clipped))
        critic_loss = torch.mean(torch.square(values - returns))  # Eq. 32
        total = (actor_loss + cfg.value_coef * critic_loss
                 - cfg.entropy_coef * torch.mean(ent))
        # approx-KL vs the behaviour policy, the fraction of ratios the clip
        # bites, and the policy entropy
        diag = (torch.mean(old_logprob - lp),
                torch.mean((torch.abs(ratio - 1.0) > cfg.clip_eps).float()),
                torch.mean(ent))
        return total, (actor_loss, critic_loss, torch.mean(ratio)) + diag

    opt = adamw(cfg.lr)
    for _ in range(cfg.update_epochs):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = loss_fn(tree_unflatten(params, leaves))
            grads = torch.autograd.grad(loss, leaves)
        upd, opt_state = opt.update(tree_unflatten(params, grads), opt_state,
                                    params)
        params = tree_add(params, upd)
    al, cl, ratio, kl, clip, ent = (a.detach() for a in aux)
    metrics = {"loss": loss.detach(), "actor_loss": al, "critic_loss": cl,
               "mean_ratio": ratio, "mean_return": returns.mean(),
               "approx_kl": kl, "clip_fraction": clip, "entropy": ent,
               "value_loss": cl, "adv_mean": adv_raw.mean(),
               "adv_std": _std(adv_raw)}
    return params, opt_state, metrics
