"""HAPFL transformer train step: the joint (local model + LiteModel) KD step.

Counterpart of ``repro.train.step``: the paper's local training (Eqs.
33-35) applied to the assigned architectures. One forward of the
heterogeneous local model and one of the homogeneous LiteModel, the CE +
bidirectional-KL losses, one AdamW update of both.

The loss is taken as `repro_torch.core.distill.make_mutual_train_fns`
takes it: it is a fixed combination of the four kd terms, so its logit
gradients are known in closed form, and one `kd_loss_grad` launch on the
(1, B*S, V) logits (one client: the reference's ``mutual_kd_loss`` takes one
mean over all B*S rows; an audio model's (B, S, nq, V) logits are B*S*nq
rows) gives them with the loss's means; autograd then carries them through
both models. A leaf the loss does not read (a VLM's token embedding, whose
inputs are embeddings) gets a zero gradient, as under
``jax.value_and_grad``. The chunked path launches it once per
sequence chunk, with the lambdas divided by the chunk count.

An MoE model adds its router's losses, moe_aux_coef * lb_loss +
z_loss_coef * z_loss (each summed over its layers), to the loss, as the
reference does. Their gradients come out of the same single
`torch.autograd.grad` call as the logits': the aux tensors are extra
outputs whose upstream gradients are the coefficients.

The step updates its state in place (params, AdamW's m and v: the
optimizer's `update_`), where the reference returns a new state and its
training loop (`launch/train.py`) donates the old one.

Phase spans (`repro_torch.obs.trace.phase`; off unless a tracer or a
profiler records them): ``train.step`` around the whole step,
``train.loss_and_grads`` around each call of `loss_and_grads`,
``train.backward`` around each `torch.autograd.grad` call (remat's
recompute included) and ``train.update`` around the norm, the clip and
AdamW.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import LAMBDAS
from repro_torch.kernels.ops import kd_loss_grad_op
from repro_torch.models.api import init_model
from repro_torch.models.transformer import apply_model, unembed
from repro_torch.obs.trace import phase
from repro_torch.optim import adamw, clip_scale, global_norm
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class TrainStepConfig:
    lambdas: Tuple[float, float, float, float] = LAMBDAS
    lr: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moe_aux_coef: float = 0.01
    z_loss_coef: float = 1e-3
    microbatch: int = 0           # >0: grad-accumulate over microbatches
    loss_chunk: int = 0           # >0: compute loss in sequence chunks


def make_train_state(gen: torch.Generator, cfg_local: ModelConfig,
                     cfg_lite: ModelConfig,
                     tcfg: TrainStepConfig = TrainStepConfig(), device=None):
    """{"params": {"local", "lite"}, "opt": AdamW state}; both models drawn
    from `gen` (local first), which must live on `device` (CUDA when
    None)."""
    params = {"local": init_model(gen, cfg_local, device),
              "lite": init_model(gen, cfg_lite, device)}
    opt = adamw(tcfg.lr, weight_decay=tcfg.weight_decay)
    return {"params": params, "opt": opt.init(params)}


def _metrics(means: torch.Tensor, lambdas) -> Dict[str, torch.Tensor]:
    """The reference's metrics from kd_loss_grad's means (rows ce_x, ce_y,
    kl_xy, kl_yx, ...; one client): loss = L1 + L2 as it sums them."""
    l1, l2, l3, l4 = lambdas
    ce_x, ce_y, kl_xy, kl_yx = means[0, 0], means[1, 0], means[2, 0], \
        means[3, 0]
    return {"ce_local": ce_x, "ce_lite": ce_y, "kl_local_lite": kl_xy,
            "kl_lite_local": kl_yx,
            "loss": (l1 * ce_x + l2 * kl_xy) + (l3 * ce_y + l4 * kl_yx)}


def _kd_grads(ll: torch.Tensor, lt: torch.Tensor, labels: torch.Tensor,
              lambdas):
    """kd_loss_grad on (..., V) logits of both models as one client of all
    their rows: (dx, dy) shaped as the logits, and the means."""
    V = ll.shape[-1]
    dx, dy, means = kd_loss_grad_op(ll.detach().reshape(1, -1, V),
                                    lt.detach().reshape(1, -1, V),
                                    labels.reshape(1, -1), lambdas)
    return dx.view(ll.shape), dy.view(lt.shape), means


def _aux_terms(tcfg, auxes, metrics):
    """The MoE models' aux losses as extra outputs of the backward: (the
    tensors, their upstream gradients, the coefficients as 0-d tensors).
    Adds their weighted sum to metrics["loss"] and, for an MoE local
    model, sets metrics["lb_loss"], as the reference does."""
    outs, coefs = [], []
    for aux in auxes:
        for key, coef in (("lb_loss", tcfg.moe_aux_coef),
                          ("z_loss", tcfg.z_loss_coef)):
            if key in aux:
                outs.append(aux[key])
                coefs.append(torch.tensor(coef, dtype=aux[key].dtype,
                                          device=aux[key].device))
    if auxes[0]:
        metrics["lb_loss"] = auxes[0]["lb_loss"].detach()
    for t, c in zip(outs, coefs):
        metrics["loss"] = metrics["loss"] + c * t.detach()
    return outs, coefs


def _losses(live, cfg_local, cfg_lite, tcfg, batch, leaves: List):
    """(metrics, grads of `leaves`) of one batch through `live` params, whose
    leaves are `leaves`."""
    if tcfg.loss_chunk:
        return _losses_chunked(live, cfg_local, cfg_lite, tcfg, batch, leaves)
    with torch.enable_grad():
        ll, _, aux_l = apply_model(live["local"], cfg_local, batch)
        lt, _, aux_t = apply_model(live["lite"], cfg_lite, batch)
        dx, dy, means = _kd_grads(ll, lt, batch["labels"], tcfg.lambdas)
        metrics = _metrics(means, tcfg.lambdas)
        outs, coefs = _aux_terms(tcfg, (aux_l, aux_t), metrics)
        with phase("train.backward"):
            grads = torch.autograd.grad([ll, lt] + outs, leaves,
                                        grad_outputs=[dx, dy] + coefs,
                                        allow_unused=True)
    return metrics, [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]


def _losses_chunked(live, cfg_local, cfg_lite, tcfg, batch, leaves: List):
    """Sequence-chunked loss: the (B, S, V) fp32 logits of both models are
    the largest training activations; unembedding and the loss run one
    sequence chunk at a time, so the live logits are (B, loss_chunk, V).
    Each chunk's gradient goes back to the final residual streams and the
    unembedding at once; the blocks' backward runs once, at the end."""
    with torch.enable_grad():
        (xl, dl), _, aux_l = apply_model(live["local"], cfg_local, batch,
                                         return_hidden=True)
        (xt, dt), _, aux_t = apply_model(live["lite"], cfg_lite, batch,
                                         return_hidden=True)
    hidden = [xl, dl, xt, dt]
    cut = [h.detach().requires_grad_(True) for h in hidden]
    labels = batch["labels"]
    S = xl.shape[1]
    ck = min(tcfg.loss_chunk, S)
    if S % ck:
        raise ValueError(f"loss_chunk {ck} does not divide seq {S}")
    nc = S // ck
    lambdas = tuple(v / nc for v in tcfg.lambdas)
    io = [live["local"]["io"], live["lite"]["io"]]
    io_leaves = tree_leaves(io)
    io_grads = [torch.zeros_like(t) for t in io_leaves]
    cut_grads = [torch.zeros_like(t) for t in cut]
    loss, chunks = 0.0, []
    for i in range(nc):
        sl = slice(i * ck, (i + 1) * ck)
        with torch.enable_grad():
            ll = unembed(io[0], cfg_local, cut[0][:, sl], cut[1][:, sl])
            lt = unembed(io[1], cfg_lite, cut[2][:, sl], cut[3][:, sl])
            dx, dy, means = _kd_grads(ll, lt, labels[:, sl], lambdas)
            with phase("train.backward"):
                g = torch.autograd.grad([ll, lt], io_leaves + cut,
                                        grad_outputs=[dx, dy],
                                        allow_unused=True)
        for acc, gi in zip(io_grads + cut_grads, g):
            if gi is not None:    # an untied model's embedding
                acc.add_(gi)
        m = _metrics(means, tcfg.lambdas)
        loss = loss + m.pop("loss") / nc
        chunks.append(m)
    metrics = {k: torch.stack([m[k] for m in chunks]).mean()
               for k in chunks[0]}
    metrics["loss"] = loss
    outs, coefs = _aux_terms(tcfg, (aux_l, aux_t), metrics)
    with torch.enable_grad(), phase("train.backward"):
        grads = torch.autograd.grad(hidden + outs, leaves,
                                    grad_outputs=cut_grads + coefs,
                                    allow_unused=True)
    ids = {id(t): i for i, t in enumerate(io_leaves)}
    out = []
    for leaf, g in zip(leaves, grads):
        if id(leaf) in ids:
            extra = io_grads[ids[id(leaf)]]
            g = extra if g is None else g + extra
        out.append(torch.zeros_like(leaf) if g is None else g)
    return metrics, out


def loss_and_grads(params, cfg_local: ModelConfig, cfg_lite: ModelConfig,
                   tcfg: TrainStepConfig, batch: Dict[str, torch.Tensor]):
    """(metrics, grads) of one batch: the step's metrics before clipping
    (no grad_norm) and the gradients of params {"local", "lite"}, a tree
    like params in the params' dtypes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    metrics, grads = _losses(tree_unflatten(params, leaves), cfg_local,
                             cfg_lite, tcfg, batch, leaves)
    return metrics, tree_unflatten(params, grads)


def _microbatch(key: str, v: torch.Tensor, n: int, j: int) -> torch.Tensor:
    """The j-th of n microbatches of batch entry `key`."""
    if key == "positions" and v.dim() == 3:      # (3, B, S) M-RoPE
        return v.reshape((3, n, v.shape[1] // n) + v.shape[2:])[:, j]
    return v.reshape((n, v.shape[0] // n) + v.shape[1:])[j]


def make_hapfl_train_step(cfg_local: ModelConfig, cfg_lite: ModelConfig,
                          tcfg: TrainStepConfig = TrainStepConfig()):
    """Returns train_step(state, batch) -> (state, metrics). The state is
    updated in place and returned; metrics are 0-d tensors under the
    reference's keys (ce_local, ce_lite, kl_local_lite, kl_lite_local,
    loss, lb_loss for an MoE local model, and grad_norm when
    clipping)."""
    opt = adamw(tcfg.lr, weight_decay=tcfg.weight_decay)

    def train_step(state, batch: Dict[str, torch.Tensor]):
        with phase("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        if tcfg.microbatch > 1:
            # grad accumulation: the batch axis split into n microbatches
            # (the second axis of M-RoPE's (3, B, S) positions), fp32 sums
            # of grads / n; the metrics are the last microbatch's
            n = tcfg.microbatch
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for j in range(n):
                mb = {k: _microbatch(k, v, n, j) for k, v in batch.items()}
                with phase("train.loss_and_grads"):
                    metrics, g = loss_and_grads(params, cfg_local, cfg_lite,
                                                tcfg, mb)
                for a, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(gi.float() / n)
                del g
        else:
            with phase("train.loss_and_grads"):
                metrics, grads = loss_and_grads(params, cfg_local, cfg_lite,
                                                tcfg, batch)
        with phase("train.update"):
            scale = None
            if tcfg.grad_clip:
                gn = global_norm(grads)
                scale = clip_scale(gn, tcfg.grad_clip)
                metrics["grad_norm"] = gn
            opt.update_(grads, state["opt"], params, scale)
        return state, metrics

    return train_step
