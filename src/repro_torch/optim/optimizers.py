"""Optimizers on parameter trees, as delta-returning functions, and the
in-place AdamW step the transformer trainer takes.

Mirrors the reference's minimal optax-like API, not ``torch.optim``:
``opt = adamw(lr); state = opt.init(params); updates, state =
opt.update(grads, state, params); params = tree_add(params, updates)``.
The formulas and their order of operations are the reference's: sgd keeps
``mu = m*mu + g`` and updates by ``-lr*mu``; adamw divides by
``sqrt(v/bc2) + eps``. ``lr`` is a float or a schedule, a function of the
step (1 at the first update) giving the rate as a 0-d float32 tensor.

``adamw(...).update_`` is the same AdamW step done in place: it writes m,
v, the step and the params of the state and params it is given, and keeps
no tree of fp32 gradients or updates alive at once. The reference donates
its train state to the jitted step (``launch/train.py``) for the same
reason; at 3.2 B parameters the functional update's trees would not fit on
one 80 GB card beside the state. On CUDA leaves it is one launch of
`repro_torch.kernels.adamw`'s fused kernel; elsewhere it is its plain
version `adamw_plain_`, leaf by leaf and in slices of ``SLICE_ELEMENTS``.
Both give the functional update's bits. `global_norm` likewise launches
that module's sum-of-squares kernels on CUDA (another order of summation)
and sums leaf by leaf elsewhere.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import adamw as fused
from repro_torch.utils.pytree import tree_leaves, tree_map

#: elements per slice of a leaf that `adamw_plain_` works on at once
SLICE_ELEMENTS = 1 << 26


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)
    # (grads, state, params, scale=None) -> None: the update, in place
    update_: Optional[Callable[..., None]] = None


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1):
    """Linear warmup over `warmup` steps, then a cosine from lr down to
    final_frac * lr at total_steps."""
    def sched(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return sched


def _dense(grads):
    """The gradient leaves, each contiguous, as the kernels read them:
    autograd may hand one in another layout (an audio model's per-codebook
    head's, from its einsum's backward, is (d, nq, V) in memory); that one
    is copied, the others are passed as they are."""
    return [g.contiguous() for g in tree_leaves(grads)]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32:
    on CUDA leaves the fused kernels' one pass (`kernels.adamw.global_norm`),
    elsewhere the plain sum below."""
    leaves = tree_leaves(grads)
    if leaves and leaves[0].device.type == "cuda":
        return fused.global_norm(_dense(leaves))
    return global_norm_plain(leaves)


def global_norm_plain(grads) -> torch.Tensor:
    """`global_norm`'s plain version, on any device: each leaf's sum of
    squares in fp32, summed over the leaves in order."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that scales gradients of global norm gn to at most
    max_norm."""
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, in fp32 as the
    reference's product with an fp32 scale is, and the norm before)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def rate(step):
        return lr(step) if callable(lr) else lr

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = rate(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return (tree_map(lambda m: (-lr_t * m).to(m.dtype), mu),
                    {"step": step, "mu": mu})
        return (tree_map(lambda g: (-lr_t * g).to(g.dtype), grads),
                {"step": step, "mu": None})
    return Optimizer(init, update)


def _adamw_factors(step, lr, b1, b2):
    """(the rate, 1 - b1^t, 1 - b2^t) of step t (1 at the first update)."""
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
    return (lr(step) if callable(lr) else lr), bc1, bc2


def _adamw_delta(m_, v_, p, lr_t, bc1, bc2, eps, weight_decay):
    u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
    if weight_decay:
        u = u + weight_decay * p.float()
    return (-lr_t * u).to(p.dtype)


def adamw_plain_(grads, state, params, scale=None, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> None:
    """`adamw(lr, b1, b2, eps, weight_decay).update_`'s plain version, on
    any device: the same writes, leaf by leaf, each in slices of about
    SLICE_ELEMENTS elements, so that its fp32 temporaries stay small."""
    step = state["step"] + 1
    lr_t, bc1, bc2 = _adamw_factors(step, lr, b1, b2)
    for g, m_, v_, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                            tree_leaves(state["v"]), tree_leaves(params)):
        rows = max(1, SLICE_ELEMENTS // max(1, p[0].numel())) \
            if p.dim() else 1
        pieces = ([(g, m_, v_, p)] if p.dim() == 0 else
                  zip(*(t.split(rows) for t in (g, m_, v_, p))))
        for gs, ms, vs, ps in pieces:
            g32 = gs.float() if scale is None else gs.float() * scale
            ms.copy_(b1 * ms + (1 - b1) * g32)
            vs.copy_(b2 * vs + (1 - b2) * (g32 * g32))
            ps.add_(_adamw_delta(ms, vs, ps, lr_t, bc1, bc2, eps,
                                 weight_decay))
    state["step"] = step


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "m": tree_map(zeros32, params),
                "v": tree_map(zeros32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t, bc1, bc2 = _adamw_factors(step, lr, b1, b2)
        g32 = tree_map(lambda g: g.float(), grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g32)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * (g * g), state["v"],
                     g32)
        updates = tree_map(lambda m_, v_, p: _adamw_delta(
            m_, v_, p, lr_t, bc1, bc2, eps, weight_decay), m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    def update_(grads, state, params, scale=None):
        """The update in place: state["m"], state["v"] and the leaves of
        params are written, state["step"] replaced. Each gradient is taken
        in fp32 and multiplied by `scale` (a 0-d tensor, the clip factor)
        when given. CUDA leaves take one launch of the fused kernel
        (`kernels.adamw.adamw_`), which gives `adamw_plain_`'s bits, and
        raises unless params, m and v are contiguous and 16-byte aligned
        (they are written in place; a gradient in another layout is
        copied); others take `adamw_plain_`."""
        p_leaves = tree_leaves(params)
        if not p_leaves or p_leaves[0].device.type != "cuda":
            return adamw_plain_(grads, state, params, scale, lr=lr, b1=b1,
                                b2=b2, eps=eps, weight_decay=weight_decay)
        step = state["step"] + 1
        lr_t, bc1, bc2 = _adamw_factors(step, lr, b1, b2)
        fused.adamw_(_dense(grads), p_leaves, tree_leaves(state["m"]),
                     tree_leaves(state["v"]), lr_t, bc1, bc2, scale, b1, b2,
                     eps, weight_decay)
        state["step"] = step
    return Optimizer(init, update, update_)
