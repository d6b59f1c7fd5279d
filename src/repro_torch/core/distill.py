"""Knowledge-distillation mutual learning (paper §IV.D, Eqs. 33-35).

Every client trains two models on the same batch:
  local model : L1 = lambda1 * CE + lambda2 * KL(local || sg(lite))
  LiteModel   : L2 = lambda3 * CE + lambda4 * KL(lite || sg(local))
`mutual_losses` is the loss, as the reference writes it: its four per-row
terms and their gradients come from the kd_loss kernels
(`repro_torch.kernels.ops.kd_loss_op`, through `kernels.kd_loss.KDLoss`),
whose backward routes L1 to the local logits only and L2 to the lite logits
only. The training step of `make_mutual_train_fns` does not differentiate it:
the loss is a fixed combination of the terms, so its logit gradients are
known in closed form, and one launch (`kernels.ops.kd_loss_grad_op`) gives
them with the loss's batch means; autograd then only carries them through
the two models.

Logits may carry a leading client axis, (C, B, V): each client's loss is its
own batch mean, and the returned loss is the sum over clients, so one
backward pass gives every client exactly its own gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.ops import kd_loss_grad_op, kd_loss_op
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_add, tree_leaves, tree_unflatten

# Paper Table II defaults
LAMBDAS = (0.4, 0.6, 0.5, 0.5)


def mutual_losses(local_logits: torch.Tensor, lite_logits: torch.Tensor,
                  labels: torch.Tensor, lambdas=LAMBDAS
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(..., B, V) logits and (..., B) labels -> (sum over leading axes of
    the per-client L1 + L2, metrics). Metrics are per-client batch means
    with the leading axes kept (scalars for (B, V) input)."""
    l1, l2, l3, l4 = lambdas
    lead = labels.shape
    V = local_logits.shape[-1]
    t = kd_loss_op(local_logits.reshape(-1, V), lite_logits.reshape(-1, V),
                   labels.reshape(-1))
    mean = {k: v.view(lead).mean(-1) for k, v in t.items()}
    per_client = (l1 * mean["ce_x"] + l2 * mean["kl_xy"]
                  + l3 * mean["ce_y"] + l4 * mean["kl_yx"])
    with torch.no_grad():
        metrics = {
            "ce_local": mean["ce_x"].detach(),
            "ce_lite": mean["ce_y"].detach(),
            "kl_local_lite": mean["kl_xy"].detach(),
            "acc_local": (local_logits.argmax(-1) == labels).float().mean(-1),
            "acc_lite": (lite_logits.argmax(-1) == labels).float().mean(-1),
        }
    return per_client.sum(), metrics


def make_mutual_train_fns(apply_local: Callable, apply_lite: Callable,
                          lr: float = 3e-4, lambdas=LAMBDAS):
    """One-batch mutual-KD SGD step over {local, lite} params (Eq. 35) and
    the optimizer init. params may be stacked over clients (C, ...) with
    images (C, B, ...); the step is then every client's step at once.

    The step's metrics are those of `mutual_losses` (per client for stacked
    params) and its loss, the sum over clients of L1 + L2; the gradients
    are those of that loss."""
    opt = sgd(lr, momentum=0.9)
    l1, l2, l3, l4 = lambdas
    weights: Dict[torch.device, torch.Tensor] = {}

    def step(params, opt_state, images, labels):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        with torch.enable_grad():
            local = apply_local(live["local"], images)
            lite = apply_lite(live["lite"], images)
            dx, dy, means = kd_loss_grad_op(local.detach(), lite.detach(),
                                            labels, lambdas)
            grads = torch.autograd.grad([local, lite], leaves,
                                        grad_outputs=[dx, dy])
        updates, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
        params = tree_add(params, updates)
        # means rows: ce_x, ce_y, kl_xy, kl_yx, acc_x, acc_y; (6, 1) for
        # unstacked params, whose metrics are scalars
        w = weights.get(means.device)
        if w is None:
            w = weights[means.device] = torch.tensor(
                [[l1], [l3], [l2], [l4]], device=means.device)
        per = means if labels.dim() > 1 else means[:, 0]
        metrics = {"ce_local": per[0], "ce_lite": per[1],
                   "kl_local_lite": per[2], "acc_local": per[4],
                   "acc_lite": per[5],
                   "loss": (w * means[:4]).sum()}
        return params, opt_state, metrics

    return step, opt.init
