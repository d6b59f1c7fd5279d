"""The yardstick's arithmetic for Zamba2 as published (`reference/zamba2.py`'s
Spec), frozen here beside `cost.py`, whose peaks and `flash_work` it reads:
a served call's model FLOPs and the bytes a decode step must move.

Model FLOPs count what the algorithm needs, 2 a multiply-add: every matrix
product with a weight that a token's forward runs (each Mamba2 layer's in
and out projections; at each of the shared blocks' calls q, k, v and o, the
MLP with its LoRA, and the call's linear; never the embedding, a lookup),
the head where a token is produced (the prompt's last position and each
decode step), causal attention's two products over each call's visible
pairs, and the recurrence's three multiply-adds a state element a token
(decay, input, read-out). Norms, the conv and gates are not counted.
"""
from __future__ import annotations

from portbench import cost


def mamba_matmul_params(spec) -> int:
    """Weights of one Mamba2 layer's projections: in (to z, xBC and dt)
    and out."""
    return spec.d * (spec.inner + spec.conv_dim + spec.mamba_heads) \
        + spec.inner * spec.d


def call_matmul_params(spec) -> int:
    """Weights one shared-block call multiplies a token by: q, k, v from
    the 2 d concatenation, o, gate_up with the call's LoRA, down, and the
    call's linear."""
    d, hd, ff, r = spec.d, spec.head_dim, spec.ff, spec.adapter_rank
    attn = 2 * d * (spec.heads + 2 * spec.kv_heads) * hd + spec.heads * hd * d
    return attn + 3 * d * ff + r * (d + 2 * ff) + d * d


def block_bytes(spec, elt: int = 2) -> int:
    """One shared block's weights: its attention, its MLP and its two
    norms (a call's LoRA and linear are the call's own)."""
    d = spec.d
    return (call_matmul_params(spec) - spec.adapter_rank * (d + 2 * spec.ff)
            - d * d + 3 * d) * elt


def weight_bytes(spec, elt: int = 2) -> int:
    """Every weight once: the Mamba2 layers (A_log, dt_bias and D in fp32),
    the shared blocks, the calls' LoRAs and linears, the final norm and the
    tied embedding."""
    d, inner, nh = spec.d, spec.inner, spec.mamba_heads
    mamba = (mamba_matmul_params(spec) + spec.conv * spec.conv_dim
             + spec.conv_dim + inner + d) * elt + 3 * nh * 4
    block = block_bytes(spec, elt)
    calls = len(spec.hybrid)
    per_call = (spec.adapter_rank * (d + 2 * spec.ff) + d * d) * elt
    return (spec.layers * mamba + spec.blocks * block + calls * per_call
            + (spec.vocab * d + d) * elt)


def state_elements(spec, B: int) -> int:
    """fp32 SSM state elements of a batch of B: (layers, B, heads, P, n)."""
    return (spec.layers * B * spec.mamba_heads * spec.mamba_head_dim
            * spec.d_state)


def serve_call_flops(spec, B: int, P: int, n_new: int) -> float:
    """Model FLOPs of one batched greedy call: B prompts of P tokens, then
    n_new decode steps."""
    tokens = B * (P + n_new)
    body = (spec.layers * mamba_matmul_params(spec)
            + len(spec.hybrid) * call_matmul_params(spec))
    head = spec.d * spec.vocab * B * (1 + n_new)
    pairs = cost.visible_pairs(P) + sum(P + i + 1 for i in range(n_new))
    attn = len(spec.hybrid) * 4 * spec.head_dim * spec.heads * B * pairs
    scan = 6 * state_elements(spec, 1) * tokens
    return 2 * body * tokens + 2 * head + attn + scan


def decode_step_bytes(spec, B: int, filled: float, elt: int = 2) -> float:
    """Bytes one decode step must move: every weight once, but a shared
    block's at each of its calls (a call reads its block's 0.67 GB at the
    published widths, which the card's 50 MB L2 cannot keep from one call
    to the next); the fp32 SSM state read and written; the conv windows
    read and written; each call's KV read over the `filled` positions and
    the new k, v written; the B new embedding rows read."""
    conv = spec.layers * B * (spec.conv - 1) * spec.conv_dim * elt
    calls = len(spec.hybrid)
    kv = calls * 2 * B * spec.kv_heads * spec.head_dim * elt
    return (weight_bytes(spec, elt) + (calls - spec.blocks)
            * block_bytes(spec, elt) + 2 * 4 * state_elements(spec, B)
            + 2 * conv + kv * (filled + 1) + B * spec.d * elt)
