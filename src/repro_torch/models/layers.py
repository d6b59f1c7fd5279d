"""Core layers: initialisers, norms, rotary embeddings (RoPE and M-RoPE),
MLPs.

Counterpart of ``repro.models.layers``. RMSNorm goes through the port's
kernel wrappers: `repro_torch.kernels.ops.rmsnorm_op` alone, and
`add_rmsnorm_op` where the residual add before the norm folds into it
(`apply_add_norm`); the CUDA kernels on the card, their plain versions on
the CPU. The reference's ``shard(...)`` annotations are
dropped: `launch.axes.shard` returns its input unchanged, since eager
PyTorch has no per-activation sharding constraint.
"""
from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import add_rmsnorm_op, rmsnorm_op


# --------------------------------------------------------------------- #
# initializers: N(0, 1) draws from `gen` on `device`, made in fp32 and cast
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((fan_in, fan_out), generator=gen, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def init_norm(d: int, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":  # olmo: no learnable affine
        return {}
    raise ValueError(kind)


def apply_norm(params, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """Norm over the last axis of x (..., d), in fp32, cast back to x's
    dtype. rmsnorm runs on the (prod(...), d) rows through the kernel."""
    if kind == "rmsnorm":
        d = x.shape[-1]
        rows = x.reshape(-1, d).contiguous()
        return rmsnorm_op(rows, params["scale"], eps=eps).view(x.shape)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def apply_add_norm(params, x: torch.Tensor, delta: torch.Tensor, kind: str,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: (x + delta, norm(x + delta)).
    rmsnorm runs both in one kernel on the (prod(...), d) rows; the other
    norms add, then norm."""
    if kind == "rmsnorm":
        d = x.shape[-1]
        s, y = add_rmsnorm_op(x.reshape(-1, d).contiguous(),
                              delta.reshape(-1, d).contiguous(),
                              params["scale"], eps=eps)
        return s.view(x.shape), y.view(x.shape)
    s = x + delta
    return s, apply_norm(params, s, kind, eps)


# --------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) of which plain RoPE
    uses the first stream. With mrope_sections (M-RoPE, summing to hd/2),
    positions are (3, B, S) and rotary dimension j takes its angle from the
    stream of the section j falls in: the first mrope_sections[0] from the
    temporal stream, the next from the height, the last from the width."""
    inv = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    if mrope_sections:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        angles = positions.float()[..., None] * inv      # (3, B, S, hd/2)
        bounds = [0, *itertools.accumulate(mrope_sections)]
        angles = torch.cat([angles[i, ..., a:b] for i, (a, b) in
                            enumerate(zip(bounds, bounds[1:]))], -1)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions.float()[..., None] * inv      # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, d: int, ff: int, act: str, dtype, device):
    p = {"w_up": dense_init(gen, d, ff, dtype, device),
         "w_down": dense_init(gen, ff, d, dtype, device)}
    if act == "silu":  # swiglu
        p["w_gate"] = dense_init(gen, d, ff, dtype, device)
    return p


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["w_up"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ params["w_down"]
