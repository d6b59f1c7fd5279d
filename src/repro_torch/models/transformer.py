"""Model assembly for the attention-stack family (dense decoders).

Counterpart of ``repro.models.transformer`` for configs whose blocks are
attention + MLP. ``init_params(gen, cfg, device)`` builds the parameter tree
of the reference, leaf for leaf: block params are stacked on a leading
(n_layers, ...) axis, so a tree converted from the reference's params
(`repro_torch.convert.params_from_numpy`) drops in. A Python loop over the
layers replaces ``lax.scan``.

The MoE, SSM (mamba2, xLSTM), hybrid (zamba2), VLM (embeddings inputs,
M-RoPE) and audio (codebooks) families are not ported yet (ROADMAP §1
item 15); their configs raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import apply_attention, init_attention
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm)
from repro_torch.utils.pytree import tree_leaves, tree_map


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config of a family not ported yet."""
    missing = []
    if cfg.block_kind != "attention":
        missing.append(f"{cfg.family} ({cfg.block_kind}) blocks")
    if cfg.is_moe:
        missing.append("MoE blocks")
    if cfg.n_codebooks:
        missing.append("audio codebooks")
    if cfg.input_mode != "tokens":
        missing.append(f"{cfg.input_mode} inputs")
    if cfg.mrope_sections:
        missing.append("M-RoPE")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet "
            f"(ROADMAP §1 item 15)")


# --------------------------------------------------------------------- #
# single blocks
# --------------------------------------------------------------------- #
def init_attn_block(gen: torch.Generator, cfg: ModelConfig, device):
    return {"norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, device),
            "attn": init_attention(gen, cfg, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                            device)}


def apply_attn_block(p, cfg: ModelConfig, x, positions, cache, cache_index):
    h = apply_norm(p["norm1"], x, cfg.norm)
    attn_out, new_cache = apply_attention(p["attn"], cfg, h, positions,
                                          cache, cache_index)
    x = x + attn_out
    h = apply_norm(p["norm2"], x, cfg.norm)
    x = x + apply_mlp(p["mlp"], h, cfg.act)
    return x, new_cache, {}


def _stack_init(n: int, init_fn):
    """n draws of init_fn() stacked on a leading axis, filled one draw at a
    time so that only one unstacked copy is alive at once."""
    first = init_fn()
    out = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    for i in range(n):
        tree_map(lambda o, t: o[i].copy_(t), out,
                 first if i == 0 else init_fn())
    return out


# --------------------------------------------------------------------- #
# io: embeddings + head
# --------------------------------------------------------------------- #
def init_io(gen: torch.Generator, cfg: ModelConfig, device):
    p: Dict[str, Any] = {"norm_f": init_norm(cfg.d_model, cfg.norm,
                                             cfg.dtype, device),
                         "embed": embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, cfg.dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                               device)
    return p


def embed_inputs(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": (B, S) int}; optional "positions" (B, S)."""
    x = p["embed"][batch["tokens"].long()]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def unembed(p, cfg: ModelConfig, h):
    """Final norm and the (tied or separate) head: fp32 logits."""
    h = apply_norm(p["norm_f"], h, cfg.norm)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return (h @ w).float()


# --------------------------------------------------------------------- #
# params, caches, forward
# --------------------------------------------------------------------- #
def init_params(gen: torch.Generator, cfg: ModelConfig, device):
    check_supported(cfg)
    return {"io": init_io(gen, cfg, device),
            "blocks": _stack_init(cfg.n_layers,
                                  lambda: init_attn_block(gen, cfg, device))}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeroed decode cache {"blocks": {"k", "v": (L, B, kv_len, KV, hd)}};
    kv_len is the window for sliding-window configs (a ring buffer)."""
    check_supported(cfg)
    kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"blocks": {
        k: torch.zeros(shape, dtype=cfg.dtype, device=device)
        for k in ("k", "v")}}


def apply_model(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache=None, cache_index=None, return_hidden=False):
    """Forward pass. Returns (logits, new_cache, aux), or the final hidden
    states instead of logits when return_hidden=True.

    cache semantics: None = train; "init" = prefill (build the cache);
    a cache from `init_cache` = decode (S == 1 at position cache_index; the
    cache is updated in place and returned)."""
    check_supported(cfg)
    x, positions = embed_inputs(params["io"], cfg, batch)
    prefill = isinstance(cache, str) and cache == "init"
    decode = cache is not None and not prefill
    if decode and "positions" not in batch:
        # decode: the single token sits at absolute position cache_index
        positions = torch.full((x.shape[0], 1), cache_index,
                               device=x.device)
    blocks = params["blocks"]
    layer_caches = []
    for i in range(tree_leaves(blocks)[0].shape[0]):
        p = tree_map(lambda t: t[i], blocks)
        c = ("init" if prefill else
             tree_map(lambda t: t[i], cache["blocks"]) if decode else None)
        x, nc, _ = apply_attn_block(p, cfg, x, positions, c, cache_index)
        layer_caches.append(nc)
    new_cache = None
    if prefill:
        new_cache = {"blocks": tree_map(lambda *ts: torch.stack(ts),
                                        *layer_caches)}
    elif decode:
        new_cache = cache
    if return_hidden:
        return x, new_cache, {}
    return unembed(params["io"], cfg, x), new_cache, {}
