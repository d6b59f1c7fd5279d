"""Optimizers on parameter trees, as delta-returning functions.

Mirrors the reference's minimal optax-like API, not ``torch.optim``:
``opt = adamw(lr); state = opt.init(params); updates, state =
opt.update(grads, state, params); params = tree_add(params, updates)``.
The formulas are the reference's: sgd keeps ``mu = m*mu + g`` and updates by
``-lr*mu``; adamw divides by ``sqrt(v/bc2) + eps``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr * m, mu), {"step": step, "mu": mu}
        return tree_map(lambda g: -lr * g, grads), {"step": step, "mu": None}
    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "m": tree_map(zeros32, params),
                "v": tree_map(zeros32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        g32 = tree_map(lambda g: g.float(), grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g32)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     g32)
        t = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)

        def upd(m_, v_, p):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}
    return Optimizer(init, update)
