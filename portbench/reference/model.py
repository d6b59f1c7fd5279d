"""The plain reference of the benchmark's transformer configurations, in
plain PyTorch and float32 (TF32 off): a decoder of pre-norm blocks, each
RMSNorm, grouped-query causal attention with rotary positions (M-RoPE:
each rotary section takes its angle from its own position stream), RMSNorm
again, and either a SwiGLU MLP or a routed mixture of experts.

The expert layer follows the configuration's stated semantics: a softmax
router in fp32, the top-k experts of each token with their probabilities
renormalised, and a capacity of ceil(n k cf / E) slots an expert (padded
up to a multiple of 8, at least 8) for each group of n tokens dispatched
together; a (token, slot) pair whose expert already holds that many earlier
pairs of its group, in token-major order, is dropped. The groups are the
tokens that one call of the model dispatches together: a whole training
batch; a serving call's prompts; one decode step's tokens. The router's
load-balance loss (top-1 assignment share times mean probability, times E)
and z-loss are summed over the layers.

Nothing here imports the program: the weights come from `portbench.weights`,
made from the seed, and are upcast to fp32 here layer by layer.

`precision="fp8"` is the benchmark's control: every matrix product with a
weight takes both operands rounded to float8 e4m3 with one scale a tensor
(its largest magnitude over 448), as an fp8 path of the program would; the
backward passes gradients straight through the rounding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = float("-inf")


@dataclass(frozen=True)
class Spec:
    """A model's sizes as the reference reads them from a configuration
    file (`from_config`)."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    capacity_factor: float = 1.25
    eps: float = 1e-5
    rope_theta: float = 10000.0
    mrope: Tuple[int, ...] = ()
    tie: bool = False
    embeddings_in: bool = False
    dtype: str = "bfloat16"


def from_config(cj: dict, lite: bool = False) -> Spec:
    """The Spec of configuration file `cj` (HF-named keys), or of its
    LiteModel (`cj["lite"]`, whose keys override the model's)."""
    src = dict(cj)
    if lite:
        src.update(cj["lite"])
    rs = src.get("rope_scaling") or {}
    experts = src.get("num_experts", 0)
    return Spec(
        layers=src["num_hidden_layers"], d=src["hidden_size"],
        heads=src["num_attention_heads"], kv_heads=src["num_key_value_heads"],
        head_dim=src.get("head_dim") or (src["hidden_size"]
                                         // src["num_attention_heads"]),
        ff=0 if experts else src["intermediate_size"],
        vocab=src["vocab_size"], experts=experts,
        top_k=src.get("num_experts_per_tok", 0) if experts else 0,
        moe_ff=src.get("moe_intermediate_size", 0) if experts else 0,
        capacity_factor=src.get("capacity_factor", 1.25),
        eps=src["rms_norm_eps"], rope_theta=src["rope_theta"],
        mrope=tuple(rs.get("mrope_section", ())),
        tie=src["tie_word_embeddings"],
        embeddings_in=src.get("input_mode", "tokens") == "embeddings",
        dtype=src["torch_dtype"])


def capacity(n_tokens: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * k * cf / E))
    return max(8, ((c + 7) // 8) * 8)


# --------------------------------------------------------------------- #
# the control's rounding
# --------------------------------------------------------------------- #
def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (amax / 448), back in fp32;
    the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return t + (q - t.detach())


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(x) @ _fp8(w)
    return x @ w


# --------------------------------------------------------------------- #
# pieces
# --------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, spec: Spec) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S), or (3, B, S) for M-RoPE, whose
    rotary dimension j < hd/2 takes its angle from the stream of the
    section it falls in. Rotate-half convention: the first and second
    halves of hd are the pairs' two coordinates."""
    hd = x.shape[-1]
    inv = 1.0 / (spec.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    inv = inv.float()
    if spec.mrope:
        stream = torch.repeat_interleave(
            torch.arange(len(spec.mrope), device=x.device),
            torch.tensor(spec.mrope, device=x.device))       # (hd/2,)
        pos = positions.float()                               # (3, B, S)
        ang = pos.permute(1, 2, 0)[..., stream] * inv         # (B, S, hd/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(w: Dict[str, torch.Tensor], h: torch.Tensor,
              positions: torch.Tensor, spec: Spec,
              precision: str) -> torch.Tensor:
    """Causal grouped-query attention of h (B, S, d): query head i reads
    key/value head i // (heads / kv_heads)."""
    B, S, _ = h.shape
    H, KV, hd = spec.heads, spec.kv_heads, spec.head_dim
    q = mm(h, w["wq"], precision).view(B, S, H, hd)
    k = mm(h, w["wk"], precision).view(B, S, KV, hd)
    v = mm(h, w["wv"], precision).view(B, S, KV, hd)
    q, k = rope(q, positions, spec), rope(k, positions, spec)
    G = H // KV
    q = q.permute(0, 2, 1, 3)                                 # (B, H, S, hd)
    k = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    mask = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    outs = []
    for b in range(B):              # one row at a time bounds the scores
        s = (q[b] @ k[b].transpose(-1, -2)) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), -1)
        outs.append(p @ v[b])
    o = torch.stack(outs).permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return mm(o, w["wo"], precision)


def mlp(w: Dict[str, torch.Tensor], h: torch.Tensor,
        precision: str) -> torch.Tensor:
    g = torch.nn.functional.silu(mm(h, w["w_gate"], precision))
    return mm(g * mm(h, w["w_up"], precision), w["w_down"], precision)


def moe(w: Dict[str, torch.Tensor], h: torch.Tensor, spec: Spec,
        groups: Optional[Sequence[torch.Tensor]], precision: str,
        stats: Optional[dict] = None):
    """The routed FFN of h (N, d) -> (y (N, d), lb_loss, z_loss). `groups`:
    index tensors of the rows dispatched together, each in its dispatch
    order (None: all rows, in order). `stats`, when given, gets per group
    the number of distinct experts its kept pairs reach ("experts")."""
    N, d = h.shape
    E, k = spec.experts, spec.top_k
    logits = mm(h, w["router"], precision)
    probs = torch.softmax(logits, -1)
    top_p, top_i = torch.topk(probs, k, -1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    first = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(0)
    lb = E * (probs.mean(0) * first).sum()
    z = torch.logsumexp(logits, -1).square().mean()
    y = torch.zeros_like(h)
    if groups is None:
        groups = [torch.arange(N, device=h.device)]
    tok_all, exp_all, wt_all = [], [], []
    for rows in groups:
        C = capacity(rows.numel(), k, E, spec.capacity_factor)
        ei = top_i[rows].reshape(-1)                 # pairs, token-major
        onehot = torch.nn.functional.one_hot(ei, E)
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1  # place in its expert
        keep = pos < C
        toks = rows[:, None].expand(-1, k).reshape(-1)[keep]
        exps = ei[keep]
        wts = top_p[rows].reshape(-1)[keep]
        if stats is not None:
            stats.setdefault("experts", []).append(int(exps.unique().numel()))
        tok_all.append(toks)
        exp_all.append(exps)
        wt_all.append(wts)
    toks, exps, wts = (torch.cat(t) for t in (tok_all, exp_all, wt_all))
    for e in range(E):
        sel = (exps == e).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        t = toks[sel]
        xe = h[t]
        g = torch.nn.functional.silu(mm(xe, w["e_gate"][e], precision))
        out = mm(g * mm(xe, w["e_up"][e], precision), w["e_down"][e],
                 precision)
        y = y.index_add(0, t, out * wts[sel][:, None])
    return y, lb, z


def block(w: Dict[str, torch.Tensor], x: torch.Tensor,
          positions: torch.Tensor, spec: Spec, precision: str = "fp32",
          groups=None, stats=None):
    """One block on x (B, S, d) -> (x, lb_loss, z_loss); losses are 0 for a
    dense block."""
    B, S, d = x.shape
    a = rmsnorm(x, w["norm1.scale"], spec.eps)
    x = x + attention(w, a, positions, spec, precision)
    b = rmsnorm(x, w["norm2.scale"], spec.eps)
    if spec.experts:
        y, lb, z = moe(w, b.reshape(B * S, d), spec, groups, precision,
                       stats)
        return x + y.view(B, S, d), lb, z
    zero = x.new_zeros(())
    return x + mlp(w, b, precision), zero, zero


def embed(io: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
          spec: Spec) -> torch.Tensor:
    """The first residual stream, fp32: a VLM's given embeddings, or the
    token table's rows."""
    if spec.embeddings_in:
        return inputs["embeddings"].float()
    return io["embed"][inputs["tokens"].long()].float()


def head(io: Dict[str, torch.Tensor], x: torch.Tensor, spec: Spec,
         precision: str = "fp32") -> torch.Tensor:
    """Final norm and output head: fp32 logits (..., V)."""
    h = rmsnorm(x, io["norm_f.scale"], spec.eps)
    w = io["embed"].T if spec.tie else io["head"]
    return mm(h, w, precision)


def upcast(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in group.items()}


def set_exact_matmuls() -> None:
    """fp32 products in full fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward_logits(spec: Spec, layer_weights, io, inputs, positions,
                   precision: str = "fp32", groups=None,
                   rows: Optional[torch.Tensor] = None, stats=None):
    """Full forward of inputs through `layer_weights(l)` (a dict of fp32
    tensors for block l) and `io`, without gradients: the logits at the
    (B, S) positions selected by boolean `rows` (all when None)."""
    with torch.no_grad():
        x = embed(io, inputs, spec)
        for l in range(spec.layers):
            x, _, _ = block(layer_weights(l), x, positions, spec, precision,
                            groups, stats)
        if rows is not None:
            x = x[rows]
        return head(io, x, spec, precision)
