"""Mixture-of-Experts layer: top-k routing, capacity-based scatter dispatch.

Counterpart of ``repro.models.moe``. Tokens are scattered into an (E, C, d)
buffer, so every expert runs one batched matrix product (`torch.bmm` over
the stacked expert weights as they lie); a (token, slot) pair past its
expert's capacity C is dropped, and the router carries the load-balance and
z losses. The arithmetic is the reference's, step by step, so that the same
tokens drop.

Dispatch runs in G groups (GShard-style, `_moe_groups`): one per
data-parallel shard of the current mesh (`launch.axes.use_axis_rules`), 1
without one. Each group of N / G tokens has its own capacity C and its own
positions, so which pairs drop depends on G, as in the reference. The port
computes every group on every rank (its model code runs replicated); the
aux losses are taken over all groups.

No step syncs with the host: C comes from shapes alone, the routing and the
positions are tensor ops, and dropped pairs go to a sentinel row that is
thrown away. So the decode step, MoE blocks included, is captured into one
CUDA graph (`serve/engine.py`). Every expert runs at every step, even one
that no token reached, as in the reference.

Each eager call is one ``moe.layer`` phase span
(`repro_torch.obs.trace.phase`: two a layer a training step under remat,
whose backward runs the forward again); a call being captured into a CUDA
graph adds none.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.axes import current_mesh, current_rules
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import dense_init
from repro_torch.obs.trace import phase
from repro_torch.utils.device import resolve_device


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None,
             d_model=None):
    """{"router": (d, E) fp32, "w_up", "w_gate": (E, d, ff), "w_down":
    (E, ff, d) in cfg.dtype} on `device` (CUDA when None; `gen` must live
    there), the expert stacks drawn N(0, 1) in fp32 and scaled by 1/sqrt(d)
    (w_down: 1/sqrt(ff)) as the reference scales them."""
    device = resolve_device(device)
    d = d_model or cfg.d_model
    E, ff = cfg.n_experts, cfg.moe_d_ff
    scale = 1.0 / math.sqrt(d)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "router": dense_init(gen, d, E, torch.float32, device),
        "w_up": (normal((E, d, ff)) * scale).to(cfg.dtype),
        "w_gate": (normal((E, d, ff)) * scale).to(cfg.dtype),
        "w_down": (normal((E, ff, d)) / math.sqrt(ff)).to(cfg.dtype),
    }


def expert_capacity(n_tokens: int, k: int, E: int,
                    capacity_factor: float) -> int:
    """Slots per expert: ceil(n k cf / E), padded up to a multiple of 8 and
    at least 8, as the reference pads it (the pad decides which pairs
    drop)."""
    c = int(math.ceil(n_tokens * k * capacity_factor / E))
    return max(8, ((c + 7) // 8) * 8)


def route(router: torch.Tensor, cfg: ModelConfig, x: torch.Tensor):
    """Router of x (N, d): (logits (N, E) fp32, probs, top_p (N, k)
    renormalised, top_i (N, k) in descending probability)."""
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    return logits, probs, top_p, top_i


def dispatch_slots(top_i: torch.Tensor, E: int, C: int):
    """(dest, keep) of the N k (token, slot) pairs in token-major order: a
    pair's position in its expert is the count of earlier pairs routed to
    it; pairs at position C or later drop to the sentinel row E C. top_i
    (N, k), or (G, Ng, k) for G groups counted apart: (G, Ng k) out."""
    flat_e = top_i.reshape(top_i.shape[:-2] + (-1,))
    # (E, N k), each expert's running count along its row: a scan over the
    # innermost axis, which the card runs row-parallel (over the outer axis
    # of an (N k, E) tensor it runs E columns of N k steps each)
    onehot = torch.arange(E, device=flat_e.device)[:, None] == flat_e[
        ..., None, :]
    pos = onehot.cumsum(-1, dtype=torch.int32).gather(
        -2, flat_e[..., None, :])[..., 0, :] - 1
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    return dest, keep


def _moe_groups(cfg: ModelConfig, n_tokens: int) -> int:
    """Dispatch groups: the product of the current mesh's batch axes (its
    data-parallel degree), halved until it divides n_tokens; 1 without a
    mesh."""
    mesh = current_mesh()
    g = 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for a in current_rules().get("batch", ()):
            if a in sizes:
                g *= sizes[a]
    while g > 1 and n_tokens % g != 0:
        g //= 2
    return max(g, 1)


def apply_moe(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), aux {"lb_loss", "z_loss",
    "dropped_frac"}: 0-d fp32 tensors)."""
    with phase("moe.layer"):
        return _apply_moe(params, cfg, x)


def _apply_moe(params, cfg: ModelConfig, x: torch.Tensor):
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    G = _moe_groups(cfg, N)
    Ng = N // G
    xt = x.reshape(N, d)
    logits, probs, top_p, top_i = route(params["router"], cfg, xt)

    # aux losses (Switch / GShard) over all groups' tokens: only the top-1
    # expert counts in ce
    me = probs.mean(0)
    ce = (top_i[:, :1] == torch.arange(E, device=x.device)).float().mean(0)
    lb_loss = E * (me * ce).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    # per-group capacity dispatch: group g's pairs go to rows [g R, (g + 1)
    # R) of one (G R, d) buffer, R = E C + 1 with its own sentinel row
    C = expert_capacity(Ng, k, E, cfg.capacity_factor)
    R = E * C + 1
    dest, keep = dispatch_slots(top_i.view(G, Ng, k), E, C)
    if G > 1:
        dest = dest + R * torch.arange(G, device=x.device)[:, None]
    dest = dest.reshape(N * k)
    xr = xt[:, None].expand(N, k, d).reshape(N * k, d)  # each token k times
    buf = x.new_zeros((G * R, d)).index_add(0, dest, xr).view(G, R, d)
    # (E, G C, d): each expert's slots of every group in one product
    expert_in = buf[:, :-1].reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    h = F.silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(
        expert_in, params["w_up"])
    expert_out = torch.bmm(h, params["w_down"])            # (E, G C, d)
    out_buf = torch.cat([
        expert_out.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d),
        x.new_zeros((G, 1, d))], dim=1).view(G * R, d)
    y = out_buf.index_select(0, dest).view(N, k, d) * top_p.to(x.dtype)[..., None]
    y = y.sum(1).view(B, S, d)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux
