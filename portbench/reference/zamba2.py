"""The plain reference of Zamba2 as published (Zamba2-7B-Instruct's
config.json; the equations of HF transformers'
``models/zamba2/modeling_zamba2.py``, its torch path), in plain PyTorch and
float32 with TF32 off, for the benchmark's zamba2 cells. It imports
neither the program nor transformers.

The model: the token embedding e; 81 Mamba2 layers, each h <- h +
mamba(RMSNorm(h + T)), where T is 0 except at the hybrid layers
(`Spec.hybrid`), at which call i of shared block i % 2 runs on h and e:

    a = RMSNorm(concat(h, e))                          (width 2 d)
    q, k, v = a Wq, a Wk, a Wv; RoPE (rotate-half, all of hd, theta)
    o = softmax(q k^T (hd / 2)^-0.5, causal) v Wo      (no residual)
    m = RMSNorm(o); [g, u] = m W_gate_up + (m A_i) B_i  (call i's LoRA)
    T = (gelu(g) u W_down) Linear_i                    (exact gelu)

then RMSNorm, and logits against the tied embedding. A Mamba2 layer: x W_in
= [z, xBC, dt_raw]; xBC through a depthwise causal conv of 4 taps with bias,
then silu, = [x, B, C] (B and C: 2 groups of d_state; head j reads group j //
56); dt = max(softplus(dt_raw + dt_bias), time_step_min); and step by step
over positions t, per head (state P x n):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t

with A = -exp(A_log); then the gated RMSNorm over 2 groups of inner / 2
channels of y silu(z) (eps 1e-5) times its scale, and W_out.

Departures from HF, all deliberate:
  - dt is computed in fp32 and clamped at time_step_min in prefill and
    decode alike (HF's decode rounds dt + dt_bias to the model dtype);
  - the recurrent state is fp32 throughout (HF's cache holds it in the
    model dtype, bf16, between steps);
  - A_log, dt_bias and D are stored in fp32 (HF: the model dtype);
  - the scan is this recurrence over positions, never HF's or the
    program's chunked form, and its sums are rounded in that order;
  - the conv weights and biases are N(0, 1) / 2 and N(0, 1) / 10 draws
    (HF initialises them uniformly), the LoRA's B is drawn like any
    projection (HF's checkpoint holds trained values).

Weights come in groups, each made by one generator seeded from
`portbench.weights.group_seed(seed, model, group)` as `weights.make_group`
makes its groups: "io", "mamba<l>", "shared<b>", "adapter<i>" and
"linear<i>". One N(0, 1) draw a storage dtype fills the group's projections
(scaled by 1/sqrt(fan_in); the token table by 0.02); a uniform draw after it
makes dt_bias (softplus^-1 of a log-uniform dt in [time_step_min,
time_step_max], floored at time_step_floor, as HF initialises it); norms'
scales and D are ones, A_log is log(1 .. heads). So the forward holds one
layer's weights at a time, and `program_tree` builds the program's tree
(`repro_torch.models.zamba2`) from the same groups.

`precision="fp8"` is the benchmark's control, as in `reference.model`:
every product with a weight takes both operands rounded to float8 e4m3.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import model as M
from portbench.weights import group_seed


@dataclass(frozen=True)
class Spec:
    """Zamba2's sizes as the reference reads them (`from_config`)."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    d_state: int
    conv: int
    expand: int
    mamba_head_dim: int
    mamba_heads: int
    groups: int
    blocks: int
    hybrid: Tuple[int, ...]
    adapter_rank: int
    eps: float
    rope_theta: float
    dt_min: float
    dt_max: float
    dt_floor: float
    tie: bool = True
    dtype: str = "bfloat16"
    mrope: Tuple[int, ...] = ()      # none: `reference.model.rope` reads it
    embeddings_in: bool = False      # token ids in (`traffic.Traffic`)

    @property
    def inner(self) -> int:
        return self.expand * self.d

    @property
    def conv_dim(self) -> int:
        return self.inner + 2 * self.groups * self.d_state


def from_config(cj: dict) -> Spec:
    """The Spec of a zamba2 configuration file (HF Zamba2Config's keys)."""
    if cj.get("use_shared_attention_adapter") or not cj.get("use_mem_rope"):
        raise ValueError("the reference runs Zamba2 with RoPE in its shared "
                         "blocks and no attention adapters")
    d = cj["hidden_size"]
    return Spec(
        layers=cj["num_hidden_layers"], d=d,
        heads=cj["num_attention_heads"], kv_heads=cj["num_key_value_heads"],
        head_dim=cj["attention_head_dim"], ff=cj["intermediate_size"],
        vocab=cj["vocab_size"], d_state=cj["mamba_d_state"],
        conv=cj["mamba_d_conv"], expand=cj["mamba_expand"],
        mamba_head_dim=cj["mamba_headdim"], mamba_heads=cj["n_mamba_heads"],
        groups=cj["mamba_ngroups"], blocks=cj["num_mem_blocks"],
        hybrid=tuple(cj["hybrid_layer_ids"]),
        adapter_rank=cj["adapter_rank"], eps=cj["rms_norm_eps"],
        rope_theta=float(cj["rope_theta"]), dt_min=cj["time_step_min"],
        dt_max=cj["time_step_max"], dt_floor=cj["time_step_floor"],
        tie=cj["tie_word_embeddings"], dtype=cj["torch_dtype"])


# --------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------- #
#: (name, shape, dtype, kind): kind a float scales an N(0, 1) draw, "ones",
#: "a_log" (log 1 .. heads) or "dt_bias" (from the uniform draw)
Leaf = Tuple[str, tuple, torch.dtype, object]


def group_leaves(spec: Spec, group: str) -> List[Leaf]:
    d, dt, f32 = spec.d, getattr(torch, spec.dtype), torch.float32
    H, hd, ff, r = spec.heads, spec.head_dim, spec.ff, spec.adapter_rank
    if group == "io":
        return [("norm_f.scale", (d,), dt, "ones"),
                ("embed", (spec.vocab, d), dt, 0.02)]
    if group.startswith("mamba"):
        inner, nh = spec.inner, spec.mamba_heads
        return [("norm.scale", (d,), dt, "ones"),
                ("in_proj", (d, inner + spec.conv_dim + nh), dt,
                 1 / math.sqrt(d)),
                ("conv_w", (spec.conv, spec.conv_dim), dt,
                 1 / math.sqrt(spec.conv)),
                ("conv_b", (spec.conv_dim,), dt, 0.1),
                ("a_log", (nh,), f32, "a_log"),
                ("dt_bias", (nh,), f32, "dt_bias"),
                ("d_skip", (nh,), f32, "ones"),
                ("gnorm", (inner,), dt, "ones"),
                ("out_proj", (inner, d), dt, 1 / math.sqrt(inner))]
    if group.startswith("shared"):
        return [("norm1.scale", (2 * d,), dt, "ones"),
                ("wq", (2 * d, H * hd), dt, 1 / math.sqrt(2 * d)),
                ("wk", (2 * d, spec.kv_heads * hd), dt, 1 / math.sqrt(2 * d)),
                ("wv", (2 * d, spec.kv_heads * hd), dt, 1 / math.sqrt(2 * d)),
                ("wo", (H * hd, d), dt, 1 / math.sqrt(H * hd)),
                ("norm2.scale", (d,), dt, "ones"),
                ("w_gate_up", (d, 2 * ff), dt, 1 / math.sqrt(d)),
                ("w_down", (ff, d), dt, 1 / math.sqrt(ff))]
    if group.startswith("adapter"):
        return [("a", (d, r), dt, 1 / math.sqrt(d)),
                ("b", (r, 2 * ff), dt, 1 / math.sqrt(r))]
    if group.startswith("linear"):
        return [("w", (d, d), dt, 1 / math.sqrt(d))]
    raise ValueError(f"no group named {group!r}")


def make_group(spec: Spec, seed: int, model: str, group: str,
               device) -> Dict[str, torch.Tensor]:
    """The leaves of `group` in their storage dtypes, on `device`."""
    leaves = group_leaves(spec, group)
    gen = torch.Generator(device).manual_seed(group_seed(seed, model, group))
    out: Dict[str, torch.Tensor] = {}
    drawn = [l for l in leaves if isinstance(l[3], float)]
    for dt in sorted({l[2] for l in drawn}, key=str):
        mine = [l for l in drawn if l[2] == dt]
        flat = torch.randn(sum(math.prod(l[1]) for l in mine), generator=gen,
                           device=device, dtype=dt)
        at = 0
        for name, shape, _, scale in mine:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(scale)
            at += size
    for name, shape, dt, kind in leaves:
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif kind == "a_log":
            out[name] = torch.log(torch.arange(1, shape[0] + 1, dtype=dt,
                                               device=device))
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device, dtype=dt)
            lo, hi = math.log(spec.dt_min), math.log(spec.dt_max)
            t = torch.exp(u * (hi - lo) + lo).clamp(min=spec.dt_floor)
            out[name] = t + torch.log(-torch.expm1(-t))    # softplus^-1
    return out


#: a group's leaf -> its path in the program's tree under the group's key
PROGRAM_PATH = {
    "mamba": {"norm.scale": ("norm", "scale"), "in_proj": ("core", "in_proj"),
              "conv_w": ("core", "conv_w"), "conv_b": ("core", "conv_b"),
              "a_log": ("core", "a_log"), "dt_bias": ("core", "dt_bias"),
              "d_skip": ("core", "d_skip"), "gnorm": ("core", "gnorm"),
              "out_proj": ("core", "out_proj")},
    "shared": {"norm1.scale": ("norm1", "scale"), "wq": ("attn", "wq"),
               "wk": ("attn", "wk"), "wv": ("attn", "wv"),
               "wo": ("attn", "wo"), "norm2.scale": ("norm2", "scale"),
               "w_gate_up": ("mlp", "w_gate_up"), "w_down": ("mlp", "w_down")},
    "adapter": {"a": ("a",), "b": ("b",)},
    "linear": {"w": ("w",)},            # the stacked tensor itself
}


def program_tree(spec: Spec, seed: int, model: str, device) -> dict:
    """The program's parameter tree {"io", "mamba", "shared", "adapter",
    "linear"} of `model`, each stacked on a leading axis, filled group by
    group."""
    io = make_group(spec, seed, model, "io", device)
    tree: dict = {"io": {"norm_f": {"scale": io["norm_f.scale"]},
                         "embed": io["embed"]}}
    for kind, count in (("mamba", spec.layers), ("shared", spec.blocks),
                        ("adapter", len(spec.hybrid)),
                        ("linear", len(spec.hybrid))):
        sub: dict = {}
        for name, shape, dt, _ in group_leaves(spec, kind):
            _put(sub, PROGRAM_PATH[kind][name],
                 torch.empty((count,) + shape, dtype=dt, device=device))
        for i in range(count):
            g = make_group(spec, seed, model, f"{kind}{i}", device)
            for name, t in g.items():
                _get(sub, PROGRAM_PATH[kind][name])[i].copy_(t)
            del g
        tree[kind] = sub["w"] if kind == "linear" else sub
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


# --------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------- #
def mamba(w: Dict[str, torch.Tensor], x: torch.Tensor, spec: Spec,
          precision: str) -> torch.Tensor:
    """One Mamba2 mixer on the normed input x (B, T, d), the recurrence
    taken position by position."""
    Bsz, T, _ = x.shape
    inner, nh, P, n, G = (spec.inner, spec.mamba_heads, spec.mamba_head_dim,
                          spec.d_state, spec.groups)
    proj = M.mm(x, w["in_proj"], precision)
    z, xBC, dt_raw = torch.split(proj, [inner, spec.conv_dim, nh], -1)
    # depthwise causal conv: out_t = b + sum_j w_j xBC_{t - (W - 1) + j}
    W = spec.conv
    xp = F.pad(xBC, (0, 0, W - 1, 0))
    conv = w["conv_b"] + sum(xp[:, j:j + T] * w["conv_w"][j] for j in range(W))
    xs, Bm, Cm = torch.split(F.silu(conv), [inner, G * n, G * n], -1)
    dt = F.softplus(dt_raw + w["dt_bias"]).clamp(min=spec.dt_min)  # (B,T,nh)
    A = -torch.exp(w["a_log"])
    xs = xs.view(Bsz, T, nh, P)
    per = nh // G
    Bh = Bm.view(Bsz, T, G, n).repeat_interleave(per, 2)          # (B,T,nh,n)
    Ch = Cm.view(Bsz, T, G, n).repeat_interleave(per, 2)
    h = x.new_zeros((Bsz, nh, P, n))
    ys = []
    for t in range(T):
        dtt = dt[:, t]                                             # (B, nh)
        h = (torch.exp(dtt * A)[:, :, None, None] * h
             + (dtt[:, :, None] * xs[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t])
                  + w["d_skip"][:, None] * xs[:, t])
    y = torch.stack(ys, 1).reshape(Bsz, T, inner) * F.silu(z)
    y = y.view(Bsz, T, G, inner // G)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5)
    y = y.reshape(Bsz, T, inner) * w["gnorm"]
    return M.mm(y, w["out_proj"], precision)


def shared_call(w, adapter, linear, h, e, positions, spec: Spec,
                precision: str) -> torch.Tensor:
    """T of one call of a shared block on the stream h and the embedding e
    (B, T, d), full softmax over each position's prefix."""
    Bsz, T, _ = h.shape
    H, KV, hd = spec.heads, spec.kv_heads, spec.head_dim
    a = M.rmsnorm(torch.cat([h, e], -1), w["norm1.scale"], spec.eps)
    q = M.rope(M.mm(a, w["wq"], precision).view(Bsz, T, H, hd), positions,
               spec)
    k = M.rope(M.mm(a, w["wk"], precision).view(Bsz, T, KV, hd), positions,
               spec)
    v = M.mm(a, w["wv"], precision).view(Bsz, T, KV, hd)
    G = H // KV
    q = q.permute(0, 2, 1, 3)
    k = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    scale = (hd / 2) ** -0.5
    outs = []
    for b in range(Bsz):            # one row at a time bounds the scores
        s = (q[b] @ k[b].transpose(-1, -2)) * scale
        outs.append(torch.softmax(s.masked_fill(~mask, M.NEG_INF), -1) @ v[b])
    o = torch.stack(outs).permute(0, 2, 1, 3).reshape(Bsz, T, H * hd)
    m = M.rmsnorm(M.mm(o, w["wo"], precision), w["norm2.scale"], spec.eps)
    gu = (M.mm(m, w["w_gate_up"], precision)
          + M.mm(M.mm(m, adapter["a"], precision), adapter["b"], precision))
    g, u = gu.chunk(2, -1)
    y = M.mm(F.gelu(g) * u, w["w_down"], precision)
    return M.mm(y, linear["w"], precision)


def forward_logits(spec: Spec, seed: int, model: str, tokens: torch.Tensor,
                   device, precision: str = "fp32",
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (fp32) of tokens (B, T) at the (B, T) positions selected by
    boolean `rows` (all when None), the model made group by group."""
    M.set_exact_matmuls()

    def group(name):
        return M.upcast(make_group(spec, seed, model, name, device))
    with torch.no_grad():
        io = group("io")
        e = io["embed"][tokens.long()]
        Bsz, T = tokens.shape
        positions = torch.arange(T, device=e.device)[None].expand(Bsz, T)
        blocks = [group(f"shared{b}") for b in range(spec.blocks)]
        call_of = {l: i for i, l in enumerate(spec.hybrid)}
        h = e
        for l in range(spec.layers):
            w = group(f"mamba{l}")
            inp = h
            i = call_of.get(l)
            if i is not None:
                inp = h + shared_call(blocks[i % spec.blocks],
                                      group(f"adapter{i}"),
                                      group(f"linear{i}"), h, e, positions,
                                      spec, precision)
            h = h + mamba(w, M.rmsnorm(inp, w["norm.scale"], spec.eps), spec,
                          precision)
            del w, inp
        if rows is not None:
            h = h[rows]
        return M.mm(M.rmsnorm(h, io["norm_f.scale"], spec.eps), io["embed"].T,
                    precision)


def replay(spec: Spec, seed: int, model: str, prompt: torch.Tensor,
           fed: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Logits (B, n + 1, V) at positions P - 1 .. P + n - 1 of the prompts
    (B, P) followed by the n `fed` tokens (B, n), as
    `reference.serve.replay` reads a served call."""
    B, n = fed.shape
    P = prompt.shape[1]
    tokens = torch.cat([prompt.long(), fed.long()], 1)
    want = torch.zeros(tokens.shape, dtype=torch.bool, device=fed.device)
    want[:, P - 1:] = True
    out = forward_logits(spec, seed, model, tokens, fed.device, precision,
                         want)
    return out.view(B, n + 1, -1)
