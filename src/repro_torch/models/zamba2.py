"""Zamba2 as published (family "zamba2"): the layout of HF transformers'
``models/zamba2/modeling_zamba2.py`` (Zamba2-7B-Instruct's config,
`configs/zamba2_7b_instruct.py`), which the stand-in "hybrid" layout of
`models/transformer.py` is not.

  mamba layers  : n_layers Mamba2 mixers (`models/ssm.py`, B and C in
                  cfg.mamba_groups groups, the gated group RMSNorm, dt
                  clamped at cfg.dt_min), each pre-normed with its own
                  residual: h <- h + mamba(norm(h [+ T])).
  shared blocks : cfg.shared_blocks blocks taken in turn, call i on block i
                  % shared_blocks, one call before each Mamba2 layer of
                  cfg.hybrid_layer_ids. A call reads RMSNorm(concat(h, e))
                  at width 2 d, e the token embedding; attention from 2 d
                  to H heads of hd (RoPE over all of hd, scores scaled by
                  (hd / 2)^-0.5) and back to d, with no residual; RMSNorm;
                  gelu(gate) * up (exact gelu) with gate_up plus the call's
                  own rank-r LoRA; down. The call's d x d `linear` maps the
                  result to T, which joins that Mamba2 layer's input before
                  its norm and not its residual.

Params {"io": {"embed", "norm_f"[, "head"]}, "mamba": {"norm", "core"}
stacked (n_layers, ...), "shared": {"norm1", "attn", "norm2", "mlp":
{"w_gate_up", "w_down"}} stacked (shared_blocks, ...), "adapter": {"a",
"b"} and "linear" stacked (calls, ...)}. The decode cache {"mamba":
{"conv", "ssm"} (n_layers, B, ...), "shared": {"k", "v"} (calls, B,
max_len, KV, hd)}: recurrent states fp32, the conv window and KV in
cfg.dtype; the prefill builds the same keys at the prompt's length, and
the decode writes every leaf in place, so one CUDA graph replays a step.

Phase spans: ``zamba2.shared`` around each call (13 a prefill at the
published config), and `ssm.apply_mamba2`'s ``ssm.scan`` around each
chunked scan. Inference only: no remat, no training path of its own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import apply_attention
from repro_torch.models.layers import (apply_add_norm, apply_norm,
                                       dense_init, embed_init, init_norm)
from repro_torch.models.transformer import (_norm_in, _stack_init, _unstack,
                                            embed_inputs)
from repro_torch.obs.trace import phase


def calls(cfg: ModelConfig) -> int:
    """The shared blocks' calls a forward makes."""
    return len(cfg.hybrid_layer_ids)


def init_shared(gen: torch.Generator, cfg: ModelConfig, device):
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype
    return {"norm1": init_norm(2 * d, cfg.norm, dt, device),
            "attn": {"wq": dense_init(gen, 2 * d, H * hd, dt, device),
                     "wk": dense_init(gen, 2 * d, KV * hd, dt, device),
                     "wv": dense_init(gen, 2 * d, KV * hd, dt, device),
                     "wo": dense_init(gen, H * hd, d, dt, device)},
            "norm2": init_norm(d, cfg.norm, dt, device),
            "mlp": {"w_gate_up": dense_init(gen, d, 2 * ff, dt, device),
                    "w_down": dense_init(gen, ff, d, dt, device)}}


def init_params(gen: torch.Generator, cfg: ModelConfig, device):
    d, r, dt = cfg.d_model, cfg.shared_mlp_adapter_rank, cfg.dtype
    io: Dict[str, Any] = {
        "norm_f": init_norm(d, cfg.norm, dt, device),
        "embed": embed_init(gen, cfg.vocab_size, d, dt, device)}
    if not cfg.tie_embeddings:
        io["head"] = dense_init(gen, d, cfg.vocab_size, dt, device)
    params = {
        "io": io,
        "mamba": _stack_init(cfg.n_layers, lambda: {
            "norm": init_norm(d, cfg.norm, dt, device),
            "core": ssm.init_mamba2(gen, cfg, device)}),
        "shared": _stack_init(cfg.shared_blocks,
                              lambda: init_shared(gen, cfg, device)),
        "linear": _stack_init(calls(cfg),
                              lambda: dense_init(gen, d, d, dt, device))}
    if r:
        params["adapter"] = _stack_init(calls(cfg), lambda: {
            "a": dense_init(gen, d, r, dt, device),
            "b": dense_init(gen, r, 2 * cfg.d_ff, dt, device)})
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """The zeroed decode cache (module docstring)."""
    d, inner, H, P, n = ssm.mamba2_dims(cfg)
    L, C = cfg.n_layers, calls(cfg)
    kv = (C, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"mamba": {"conv": zeros((L, batch, cfg.ssm_conv - 1,
                                     ssm.mamba2_conv_dim(cfg)), cfg.dtype),
                      "ssm": zeros((L, batch, H, n, P), torch.float32)},
            "shared": {"k": zeros(kv, cfg.dtype), "v": zeros(kv, cfg.dtype)}}


def shared_call(p, adapter: Optional[Dict], linear: torch.Tensor,
                cfg: ModelConfig, h, x0, positions, cache, cache_index):
    """One call of a shared block on the stream h and the embedding x0 (B,
    S, d): (T, the attention's cache as `apply_attention` returns it)."""
    a = apply_norm(p["norm1"], torch.cat([h, x0], -1), cfg.norm)
    a, kv = apply_attention(p["attn"], cfg, a, positions, cache, cache_index,
                            scale=(cfg.resolved_head_dim / 2) ** -0.5)
    m = apply_norm(p["norm2"], a, cfg.norm)
    gu = m @ p["mlp"]["w_gate_up"]
    if adapter is not None:
        gu = gu + (m @ adapter["a"]) @ adapter["b"]
    gate, up = gu.chunk(2, -1)
    return (F.gelu(gate) * up) @ p["mlp"]["w_down"] @ linear, kv


def apply_blocks(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 cache=None, cache_index=None):
    """`models.transformer.apply_blocks` for family "zamba2": (x, delta,
    cache) with the final stream x + delta; cache None (a forward), "init"
    (prefill: the cache comes back, `init_cache`'s keys at the prompt's
    length) or a decode cache (one position at cache_index, written in
    place and returned)."""
    x0, positions = embed_inputs(params["io"], cfg, batch)
    B, S = x0.shape[:2]
    prefill = isinstance(cache, str) and cache == "init"
    decode = cache is not None and not prefill
    if decode:
        cache_index = torch.as_tensor(cache_index, device=x0.device)
        if "positions" not in batch:
            positions = cache_index.view(1, 1).expand(B, 1)
    out = init_cache(cfg, B, S, x0.device) if prefill else None
    marker = "init" if prefill else None
    layers = _unstack(params["mamba"])
    m_caches = _unstack(cache["mamba"]) if decode else [marker] * len(layers)
    s_caches = (_unstack(cache["shared"]) if decode
                else [marker] * calls(cfg))
    blocks = _unstack(params["shared"])
    adapters = (_unstack(params["adapter"]) if "adapter" in params
                else [None] * calls(cfg))
    linears = params["linear"].unbind(0)
    call_of = {l: i for i, l in enumerate(cfg.hybrid_layer_ids)}
    x, delta = x0, None
    for l, (p, c) in enumerate(zip(layers, m_caches)):
        i = call_of.get(l)
        if i is None:
            x, h = _norm_in(p["norm"], cfg, x, delta)
        else:
            x = x if delta is None else x + delta
            with phase("zamba2.shared"):
                t, kv = shared_call(blocks[i % cfg.shared_blocks],
                                    adapters[i], linears[i], cfg, x, x0,
                                    positions, s_caches[i], cache_index)
            _, h = apply_add_norm(p["norm"], x, t, cfg.norm)
            if prefill:
                out["shared"]["k"][i].copy_(kv["k"])
                out["shared"]["v"][i].copy_(kv["v"])
            del t, kv
        delta, mc = ssm.apply_mamba2(p["core"], cfg, h, c)
        if prefill:
            out["mamba"]["conv"][l].copy_(mc["conv"])
            out["mamba"]["ssm"][l].copy_(mc["ssm"])
        del h, mc
    return x, delta, cache if decode else out
