"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's peaks, the bytes and operations of the port's
kernels (copied from `repro_torch/kernels/cost.py` as it stood when the
benchmark was defined), and the whole step's model FLOPs and a decode
step's bytes, counted from the configuration's sizes.

Bytes are each input read once and each output written once; operations are
multiply-adds counted as 2. Model FLOPs count what the algorithm needs: the
matrix products of the parameters a token's forward touches (an MoE layer's
top-k experts, never the embedding table, which is a lookup), causal
attention's two products over the visible (query, key) pairs, and no
recomputation. Training is three forwards' worth (forward and two products
in the backward).
"""
from __future__ import annotations

from typing import Dict, Tuple

#: NVIDIA H100 SXM5 80 GB, datasheet figures (dense, no sparsity) at the
#: card's 700 W power limit.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s
    "peak_flops_fp32": 67e12,    # FLOP/s, outside the tensor cores
    "hbm_bw": 3.35e12,           # B/s
}


def visible_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs the masks leave visible for one head of S
    positions."""
    w = window if window and window < S else 0
    if causal:
        return S * (S + 1) // 2 if not w else w * (w + 1) // 2 + (S - w) * w
    if not w:
        return S * S
    return S * S - (S - w) * (S - w + 1) // 2


def grad_work(C: int, B: int, V: int, elt: int) -> Tuple[int, int]:
    """kd_loss_grad: x, y read and dx, dy written once, labels read and the
    (6, C) means written; about 28 fp32 operations a pair."""
    N = C * B
    return 4 * N * V * elt + 4 * N + 24 * C, 28 * N * V


def flash_work(B: int, H: int, KV: int, S: int, hd: int, elt: int,
               window: int = 0) -> Tuple[int, int]:
    """flash_attention forward: Q, O (B, H, S, hd) and K, V (B, KV, S, hd)
    moved once; QK^T and PV over the visible causal pairs."""
    nbytes = (2 * B * H + 2 * B * KV) * S * hd * elt
    return nbytes, 4 * hd * B * H * visible_pairs(S, True, window)


def flash_bwd_work(B: int, H: int, KV: int, S: int, hd: int, elt: int,
                   window: int = 0) -> Tuple[int, int]:
    """flash_attention backward: q, o, dO, dq and k, v, dk, dv moved once,
    lse read once; five products over the visible causal pairs."""
    nbytes = (4 * B * H + 4 * B * KV) * S * hd * elt + 4 * B * H * S
    return nbytes, 10 * hd * B * H * visible_pairs(S, True, window)


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(the least seconds the card could take, what sets it)."""
    t_b = nbytes / HW["hbm_bw"]
    t_o = ops / ops_per_s
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------- #
# whole-model arithmetic from a reference spec (`reference.model.Spec`)
# ---------------------------------------------------------------------- #
def layer_params(spec) -> Dict[str, int]:
    """Parameters of one block: attention, norms, and either the dense MLP,
    or the router and ONE expert (`expert`) of an MoE block."""
    d, H, KV, hd = spec.d, spec.heads, spec.kv_heads, spec.head_dim
    out = {"attn": d * H * hd + 2 * d * KV * hd + H * hd * d,
           "norms": 2 * d}
    if spec.experts:
        out["router"] = d * spec.experts
        out["expert"] = 3 * d * spec.moe_ff
    else:
        out["mlp"] = 3 * d * spec.ff
    return out


def active_params(spec) -> Tuple[int, int]:
    """(body, head): the parameters a token's forward touches in the blocks
    and the final norm (top-k experts in an MoE block), and in the output
    head (the tied embedding where the head is tied)."""
    p = layer_params(spec)
    per = p["attn"] + p["norms"] + (p.get("mlp", 0) + p.get("router", 0)
                                    + spec.top_k * p.get("expert", 0))
    return spec.layers * per + spec.d, spec.d * spec.vocab


def attention_flops(spec, B: int, S: int) -> int:
    """Forward attention products of one causal pass of B rows of S."""
    return (spec.layers * 4 * spec.head_dim * B * spec.heads
            * visible_pairs(S))


def train_step_flops(specs, B: int, S: int) -> float:
    """Model FLOPs of one training step of every model in `specs` on B rows
    of S tokens: 6 N a token plus three times the causal attention."""
    total = 0.0
    for spec in specs:
        body, head = active_params(spec)
        total += 6 * (body + head) * B * S + 3 * attention_flops(spec, B, S)
    return total


def serve_call_flops(spec, B: int, P: int, n_new: int) -> float:
    """Model FLOPs of one batched greedy call: B prompts of P tokens, then
    n_new decode steps. Every token runs the blocks; only the prompt's last
    position and the decode steps need the head; attention over the causal
    prefix of each position."""
    body, head = active_params(spec)
    tokens = B * (P + n_new)
    attn = attention_flops(spec, B, P)
    for i in range(n_new):            # decode step i sees P + i + 1 keys
        attn += spec.layers * 4 * spec.head_dim * B * spec.heads * (P + i + 1)
    return 2 * body * tokens + 2 * head * B * (1 + n_new) + attn


def decode_step_flops(spec, B: int, filled: float) -> float:
    """Model FLOPs of one decode step of B tokens over `filled` keys."""
    body, head = active_params(spec)
    return (2 * (body + head) * B
            + spec.layers * 4 * spec.head_dim * B * spec.heads * filled)


def decode_step_bytes(spec, B: int, filled: float, experts_read: float,
                      elt: int = 2) -> float:
    """Bytes one decode step must move: every weight of the blocks, the
    final norm and the head read once (an MoE block's router in fp32 and
    only `experts_read` of its experts, those the step's tokens are routed
    to); the KV cache read over the `filled` positions (the new token's
    included) and the new k, v written; the B new embedding rows read."""
    p = layer_params(spec)
    per = (p["attn"] + p["norms"] + p.get("mlp", 0)) * elt
    if spec.experts:
        per += p["router"] * 4 + experts_read * p["expert"] * elt
    kv = 2 * B * spec.kv_heads * spec.head_dim * elt
    per += kv * filled + kv
    return (spec.layers * per + spec.d * elt + spec.d * spec.vocab * elt
            + B * spec.d * elt)
