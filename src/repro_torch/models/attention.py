"""GQA attention: flash-kernel training/prefill + KV-cache decode.

Counterpart of ``repro.models.attention``. Training and prefill (more than
one new token, or building the cache) go through the port's flash-attention
wrapper (`repro_torch.kernels.ops.flash_attention_op`): the CUDA kernel on the
card, which takes the (B, S, H, hd) projections as transposed views with no
copy, and its plain version on the CPU. Decode (one new token against a cache)
writes the token's k/v into the ring-buffer cache and attends with
`gqa_attention`, plain PyTorch, over the whole cache under the reference's
mask, so that its shapes do not change from step to step.

The decode step updates the cache tensors it is given in place (the
reference returns new arrays), so a (B, L, KV, hd) cache is never copied.
``flash_decode_shardmap``, the reference's decode over a length-sharded
cache, needs a device mesh and waits for ROADMAP §1 item 13.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, cfg.dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, cfg.dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, cfg.dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, cfg.dtype, device),
    }


def _gqa_scores_chunk(q, k, v, q_start, kv_len_valid, sliding_window, causal):
    """q: (B, KV, G, qc, hd); k, v: (B, KV, S, hd) -> (B, KV, G, qc, hd).
    Scores and probabilities are rounded to the inputs' dtype where the
    reference rounds them."""
    S = k.shape[2]
    scores = torch.einsum("bkgqh,bkth->bkgqt", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    q_idx = q_start + torch.arange(q.shape[3], device=q.device)
    k_idx = torch.arange(S, device=q.device)
    mask = torch.ones((q.shape[3], S), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_idx[None, :] <= q_idx[:, None]
    if sliding_window:
        mask = mask & (k_idx[None, :] > q_idx[:, None] - sliding_window)
    if kv_len_valid is not None:
        mask = mask & (k_idx[None, :] < kv_len_valid)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, -1).to(v.dtype)
    return torch.einsum("bkgqt,bkth->bkgqh", probs, v)


def gqa_attention(q, k, v, *, causal=True, sliding_window=0, q_start=0,
                  kv_len_valid=None, q_chunk=1024):
    """q: (B, S_q, H, hd); k, v: (B, S_kv, KV, hd) -> (B, S_q, H, hd).
    Queries go in chunks of q_chunk rows, so the score matrix held at once
    is (B, KV, G, q_chunk, S_kv)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)  # (B, KV, G, Sq, hd)
    kh = k.permute(0, 2, 1, 3)                                # (B, KV, S, hd)
    vh = v.permute(0, 2, 1, 3)
    out = torch.cat([
        _gqa_scores_chunk(qh[:, :, :, i:i + q_chunk], kh, vh, q_start + i,
                          kv_len_valid, sliding_window, causal)
        for i in range(0, Sq, q_chunk)], dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def apply_attention(params, cfg: ModelConfig, x, positions,
                    cache=None, cache_index=None,
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). cache: None (train), "init" (prefill: the layer's k, v
    come back as its cache) or {"k", "v": (B, L, KV, hd)} with S == 1
    (decode at position cache_index, a 0-d int64 tensor: the token's k, v
    are written at slot cache_index % L, in place, and the query attends
    over the min(cache_index + 1, L) slots filled so far).

    Returns (out, new_cache)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if isinstance(cache, dict) and S == 1:
        # The cache is a ring buffer: for sliding-window archs it is only
        # `window` long, so decode stays O(window). cache_index is a 0-d
        # int64 tensor: the slot, the write and the mask are tensor ops, so
        # the step has no host sync and the same shapes at every position
        # (one CUDA graph replays it), and the query attends over all L
        # slots with those past min(cache_index + 1, L) masked out, as the
        # reference does.
        L = cache["k"].shape[1]
        slot = (cache_index % L).view(1)
        kv_valid = torch.clamp(cache_index + 1, max=L)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        out = gqa_attention(q, cache["k"], cache["v"], causal=False,
                            sliding_window=0, kv_len_valid=kv_valid,
                            q_start=cache_index)
        new_cache = cache
    else:
        # (B, H, S, hd) views: the kernel reads them through their strides,
        # and its output transposed back is (B, S, H, hd) contiguous on the
        # card, so the reshape below is a view there
        out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 sliding_window=cfg.sliding_window)
        out = out.transpose(1, 2)
        if cache is not None:  # prefill ("init" marker): emit cache
            new_cache = {"k": k, "v": v}
    out = out.reshape(B, S, cfg.n_heads * hd)
    return out @ params["wo"], new_cache
