"""The reference of HAPFL's local training step (Eqs. 33-35) at transformer
widths: the local model and the LiteModel learn from each other by mutual
distillation, in plain PyTorch and float32 (TF32 off).

A step's loss is, over all B S rows of both models' logits x (local) and y
(LiteModel),

    L = l1 CE(x) + l2 KL(p_x || sg p_y) + l3 CE(y) + l4 KL(p_y || sg p_x)

averaged over the rows (sg: no gradient through it), plus an MoE local
model's moe_aux_coef times its load-balance loss and z_loss_coef times its
z-loss, each summed over its layers. The gradients of both models are
clipped together to a global norm of at most `grad_clip` (scale min(1,
clip / (norm + 1e-9))) and AdamW (b1 0.9, b2 0.999, eps 1e-8, bias
corrected, decoupled weight decay) takes one step. Weights are stored
between steps in the configuration's dtype (bfloat16: each step's fp32
result rounded once), as a bf16 model's weights are; the optimizer's
moments stay fp32. Everything else is fp32.

To fit beside nothing but itself on the card, the forward runs block by
block without autograd and keeps each block's input; the loss runs in
blocks of rows; the backward runs each block again under autograd, from
its kept input, last block first.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import model as M
from portbench.weights import PROGRAM_PATH, make_group

ROWS = 512      # loss rows at once


def kd_terms(x: torch.Tensor, y: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """(4, R): each row's CE(x), CE(y), KL(p_x || sg p_y), KL(p_y || sg p_x),
    the KL terms sending gradient to their first model only."""
    lx, ly = torch.log_softmax(x, -1), torch.log_softmax(y, -1)
    lab = labels.long()[:, None]
    ce_x = -lx.gather(-1, lab)[:, 0]
    ce_y = -ly.gather(-1, lab)[:, 0]
    kl_xy = (lx.exp() * (lx - ly.detach())).sum(-1)
    kl_yx = (ly.exp() * (ly - lx.detach())).sum(-1)
    return torch.stack([ce_x, ce_y, kl_xy, kl_yx])


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """An fp32 copy of t that autograd may make a leaf of."""
    return t.detach().to(torch.float32, copy=True)


def leaf_name(model: str, group: str, name: str) -> str:
    """The program's tree path of a leaf, as "local/blocks/attn/wq": a
    block's leaves are stacked over its layers into one program leaf."""
    part = "io" if group == "io" else "blocks"
    return "/".join((model, part) + PROGRAM_PATH[name])


class Follow:
    """Follows the program's first steps from the same weights and inputs.
    `models`: [(name, Spec)], the local model first; `hp`: the cell's
    "step" parameters. `precision` "fp8" makes the control; `half_batch`
    is a planted fault (the first half of each batch's rows only)."""

    def __init__(self, models: Sequence[Tuple[str, M.Spec]], seed: int,
                 hp: dict, device, precision: str = "fp32",
                 half_batch: bool = False):
        self.models = list(models)
        self.seed = seed
        self.hp = hp
        self.device = device
        self.precision = precision
        self.half = half_batch
        self.t = 0
        self.params: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        for name, spec in self.models:
            groups = ["io"] + [f"layer{l}" for l in range(spec.layers)]
            self.params[name] = {g: make_group(spec, seed, name, g, device)
                                 for g in groups}
        self.m = {n: {g: {k: torch.zeros_like(v, dtype=torch.float32)
                          for k, v in gr.items()} for g, gr in p.items()}
                  for n, p in self.params.items()}
        self.v = {n: {g: {k: torch.zeros_like(t) for k, t in gr.items()}
                      for g, gr in p.items()} for n, p in self.m.items()}
        self.first_grads: Dict[str, float] = {}
        self.terms: List[List[float]] = []    # each step's four loss terms

    # ------------------------------------------------------------------ #
    def step(self, batch: Dict[str, torch.Tensor]) -> float:
        """One step on `batch`; returns its loss."""
        hp, prec = self.hp, self.precision
        if self.half:
            B = batch["labels"].shape[0] // 2
            batch = {k: (v[:, :B] if k == "positions" else v[:B])
                     for k, v in batch.items()}
        labels = batch["labels"]
        B, S = labels.shape
        N = B * S
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(S, device=labels.device)[None].expand(B, S)
        coef = {"lb": hp.get("moe_aux_coef", 0.0),
                "z": hp.get("z_loss_coef", 0.0)}
        kept, final, aux = {}, {}, 0.0
        for name, spec in self.models:
            io = M.upcast(self.params[name]["io"])
            with torch.no_grad():
                x = M.embed(io, batch, spec)
                ins = []
                for l in range(spec.layers):
                    ins.append(x)
                    w = M.upcast(self.params[name][f"layer{l}"])
                    x, lb, z = M.block(w, x, pos, spec, prec)
                    if spec.experts:
                        aux += coef["lb"] * float(lb) + coef["z"] * float(z)
            kept[name], final[name] = ins, x
        grads = {n: {} for n, _ in self.models}
        # the loss, ROWS rows at a time: gradients of both heads and of
        # both final residual streams
        (ln, ls), (tn, ts) = self.models[0], self.models[1]
        # a tied head's gradient reaches the token table here; the input's
        # part is added after the backward
        ios = {n: {k: _fresh(v).requires_grad_(k != "embed" or spec.tie)
                   for k, v in self.params[n]["io"].items()}
               for n, spec in self.models}
        dfin = {n: torch.zeros_like(final[n]).view(N, -1) for n in (ln, tn)}
        sums = torch.zeros(4, dtype=torch.float64, device=labels.device)
        l1, l2, l3, l4 = hp["lambdas"]
        for r in range(0, N, ROWS):
            hl = final[ln].view(N, -1)[r:r + ROWS].detach().requires_grad_()
            ht = final[tn].view(N, -1)[r:r + ROWS].detach().requires_grad_()
            with torch.enable_grad():
                terms = kd_terms(M.head(ios[ln], hl, ls, prec),
                                 M.head(ios[tn], ht, ts, prec),
                                 labels.view(N)[r:r + ROWS])
                part = (l1 * terms[0] + l2 * terms[2] + l3 * terms[1]
                        + l4 * terms[3]).sum() / N
                part.backward()
            dfin[ln][r:r + ROWS] = hl.grad
            dfin[tn][r:r + ROWS] = ht.grad
            sums += terms.detach().double().sum(1)
        ce_x, ce_y, kl_xy, kl_yx = (sums / N).tolist()
        self.terms.append([ce_x, ce_y, kl_xy, kl_yx])
        loss = (l1 * ce_x + l2 * kl_xy) + (l3 * ce_y + l4 * kl_yx) + aux
        for n, spec in self.models:
            io_g = {k: (t.grad if t.grad is not None
                        else torch.zeros_like(t)) for k, t in ios[n].items()}
            grads[n]["io"] = io_g
            g = dfin[n].view(final[n].shape)
            for l in reversed(range(spec.layers)):
                x_in = kept[n][l].detach().requires_grad_()
                w = {k: _fresh(v).requires_grad_()
                     for k, v in self.params[n][f"layer{l}"].items()}
                with torch.enable_grad():
                    out, lb, z = M.block(w, x_in, pos, spec, prec)
                    outs, gouts = [out], [g]
                    if spec.experts:
                        outs += [lb, z]
                        gouts += [torch.tensor(coef["lb"], device=g.device),
                                  torch.tensor(coef["z"], device=g.device)]
                    torch.autograd.backward(outs, gouts)
                grads[n][f"layer{l}"] = {k: t.grad for k, t in w.items()}
                g = x_in.grad
                kept[n][l] = None
            if not spec.embeddings_in:
                io_g["embed"].index_add_(0, batch["tokens"].reshape(-1).long(),
                                         g.reshape(N, -1))
        del kept, final, ios, dfin
        self._update(grads)
        return loss

    def _update(self, grads) -> None:
        hp = self.hp
        total = sum(float(t.double().square().sum()) for n in grads
                    for gr in grads[n].values() for t in gr.values())
        gn = math.sqrt(total)
        scale = min(1.0, hp["grad_clip"] / (gn + 1e-9)) \
            if hp.get("grad_clip") else 1.0
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        lr, wd = hp["lr"], hp.get("weight_decay", 0.0)
        norms: Dict[str, float] = {}
        for n in grads:
            for g_name, gr in grads[n].items():
                for k, g in gr.items():
                    g = g * scale
                    key = leaf_name(n, g_name, k)
                    norms[key] = norms.get(key, 0.0) + float(
                        g.double().square().sum())
                    m, v = self.m[n][g_name][k], self.v[n][g_name][k]
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    p = self.params[n][g_name][k]
                    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    if wd:
                        u = u + wd * p.float()
                    p.copy_((p.float() - lr * u).to(p.dtype))
        if self.t == 1:
            self.first_grads = {k: math.sqrt(v) for k, v in norms.items()}

    def change(self) -> Dict[str, float]:
        """Each program leaf's norm of its change from the start."""
        out: Dict[str, float] = {}
        for n, spec in self.models:
            for g_name, gr in self.params[n].items():
                start = make_group(spec, self.seed, n, g_name, self.device)
                for k, p in gr.items():
                    key = leaf_name(n, g_name, k)
                    out[key] = out.get(key, 0.0) + float(
                        (p.double() - start[k].double()).square().sum())
                del start
        return {k: math.sqrt(v) for k, v in out.items()}


def follow(models, seed: int, hp: dict, batches, device,
           precision: str = "fp32", half_batch: bool = False) -> dict:
    """{"losses": [...], "terms": each step's [CE(x), CE(y), KL(x||y),
    KL(y||x)], "grad": first clipped gradient's leaf norms,
    "change": leaf norms of the change after len(batches) steps}."""
    M.set_exact_matmuls()
    f = Follow(models, seed, hp, device, precision, half_batch)
    losses = [f.step(b) for b in batches]
    out = {"losses": losses, "terms": f.terms, "grad": f.first_grads,
           "change": f.change()}
    del f
    return out
