"""Knowledge-distillation mutual learning (paper §IV.D, Eqs. 33-35).

Every client trains two models on the same batch:
  local model : L1 = lambda1 * CE + lambda2 * KL(local || sg(lite))
  LiteModel   : L2 = lambda3 * CE + lambda4 * KL(lite || sg(local))
The four per-row terms and their gradients come from the kd_loss kernel
(`repro_torch.kernels.ops.kd_loss_op`, through `kernels.kd_loss.KDLoss`), whose backward routes L1 to the
local logits only and L2 to the lite logits only.

Logits may carry a leading client axis, (C, B, V): each client's loss is its
own batch mean, and the returned loss is the sum over clients, so one
backward pass gives every client exactly its own gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.ops import kd_loss_op
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
    images (C, B, ...); the step is then every client's step at once."""
    opt = sgd(lr, momentum=0.9)

    def step(params, opt_state, images, labels):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss, metrics = mutual_losses(apply_local(live["local"], images),
                                          apply_lite(live["lite"], images),
                                          labels, lambdas)
            grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
        params = tree_add(params, updates)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step, opt.init
