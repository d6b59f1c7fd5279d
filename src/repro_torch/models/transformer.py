"""Model assembly for the attention-stack family: dense, MoE, VLM and audio.

Counterpart of ``repro.models.transformer`` for configs whose blocks are
attention + MLP, or attention + a routed expert FFN (`models/moe.py`) in
MoE configs. The families differ only in their io: token embeddings and a
(tied or separate) head; a VLM's precomputed patch embeddings
(``input_mode="embeddings"``) with (3, B, S) M-RoPE positions; an audio
model's codebook tokens (B, S, nq), embedded by one table per codebook and
summed, with one head per codebook.

``init_params(gen, cfg, device)`` builds the parameter tree of the
reference, leaf for leaf: block params are stacked on a leading
(n_layers, ...) axis, so a tree converted from the reference's params
(`repro_torch.convert.params_from_numpy`) drops in. A Python loop over the
layers replaces ``lax.scan``.

Each residual add is folded into the norm that follows it: the loop carries
the residual stream and the pending delta (the attention's or the MLP's
output), and `layers.apply_add_norm` adds and norms in one step, which is
one kernel launch (`add_rmsnorm`) for rmsnorm configs: a block's second
norm after its attention add, the next block's first norm after its MLP
add, and the final norm after the last block. Only the first block's first
norm is a plain norm. The arithmetic is the reference's: the same add, in
the same dtype, before the same norm.

With ``cfg.remat``, each block runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant) wherever autograd
records, as the reference wraps it in ``jax.checkpoint``: a block keeps
only its inputs for the backward and runs its forward again there, its
norm and flash kernels included.

An MoE block's aux losses (lb_loss, z_loss, dropped_frac) are summed over
the layers, as the reference sums them (so dropped_frac is a sum, not a
mean); a dense model's aux is {}.

The SSM (mamba2, xLSTM) and hybrid (zamba2) families are not ported yet
(ROADMAP §1 item 15); their configs raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import apply_attention, init_attention
from repro_torch.models.layers import (apply_add_norm, apply_mlp,
                                       apply_norm, dense_init, embed_init,
                                       init_mlp, init_norm)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.utils.pytree import tree_map


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config of a family not ported yet."""
    if cfg.block_kind != "attention":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} ({cfg.block_kind}) blocks are not "
            f"ported yet (ROADMAP §1 item 15)")


# --------------------------------------------------------------------- #
# single blocks
# --------------------------------------------------------------------- #
def init_attn_block(gen: torch.Generator, cfg: ModelConfig, device):
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, device),
         "attn": init_attention(gen, cfg, device),
         "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, device)}
    if cfg.is_moe:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                            device)
    return p


def apply_attn_block(p, cfg: ModelConfig, x, delta, positions, cache,
                     cache_index):
    """One block on the residual stream x, whose pending delta (the block
    before's MLP output; None for the first block) is added in this block's
    first norm. Returns (x, delta, new_cache, aux): the stream after the
    attention add, this block's MLP (or MoE) output as the next pending
    delta, and the MoE's aux losses ({} for an MLP)."""
    if delta is None:
        h = apply_norm(p["norm1"], x, cfg.norm)
    else:
        x, h = apply_add_norm(p["norm1"], x, delta, cfg.norm)
    attn_out, new_cache = apply_attention(p["attn"], cfg, h, positions,
                                          cache, cache_index)
    x, h = apply_add_norm(p["norm2"], x, attn_out, cfg.norm)
    if cfg.is_moe:
        out, aux = apply_moe(p["moe"], cfg, h)
        return x, out, new_cache, aux
    return x, apply_mlp(p["mlp"], h, cfg.act), new_cache, {}


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
                                             cfg.dtype, device)}
    V, d, dt = cfg.vocab_size, cfg.d_model, cfg.dtype
    if cfg.n_codebooks:   # audio: a table and a head per codebook
        nq = cfg.n_codebooks
        p["embed"] = torch.stack([embed_init(gen, V, d, dt, device)
                                  for _ in range(nq)])            # (nq, V, d)
        p["head"] = torch.stack([dense_init(gen, d, V, dt, device)
                                 for _ in range(nq)])             # (nq, d, V)
        return p
    p["embed"] = embed_init(gen, V, d, dt, device)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, d, V, dt, device)
    return p


def embed_inputs(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": (B, S) int}, a VLM's {"embeddings": (B, S, d)} or
    an audio model's {"tokens": (B, S, nq) int}; optional "positions" (B,
    S), or (3, B, S) for M-RoPE. Codebook embeddings are summed in the
    reference's order, q = 0 first, in cfg.dtype."""
    if cfg.input_mode == "embeddings":
        x = batch["embeddings"].to(cfg.dtype)
    elif cfg.n_codebooks:
        toks = batch["tokens"].long()
        x = p["embed"][0][toks[..., 0]]
        for q in range(1, cfg.n_codebooks):
            x = x + p["embed"][q][toks[..., q]]
    else:
        x = p["embed"][batch["tokens"].long()]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def unembed(p, cfg: ModelConfig, x, delta=None):
    """Final norm of x + delta (x alone when delta is None) and the (tied,
    separate or per-codebook) head: fp32 logits (B, S, V), or (B, S, nq, V)
    for an audio model."""
    if delta is None:
        h = apply_norm(p["norm_f"], x, cfg.norm)
    else:
        _, h = apply_add_norm(p["norm_f"], x, delta, cfg.norm)
    if cfg.n_codebooks:
        return torch.einsum("bsd,qdv->bsqv", h, p["head"]).float()
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


def apply_blocks(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 cache=None, cache_index=None):
    """Embedding and blocks. Returns (x, delta, new_cache, aux): the final
    residual stream is x + delta, whose add `unembed` folds into the final
    norm; aux holds the MoE blocks' aux losses summed over the layers ({}
    for a dense model).

    cache semantics: None = train; "init" = prefill (build the cache);
    a cache from `init_cache` = decode (S == 1 at position cache_index, an
    int or a 0-d int64 tensor on x's device; the cache is updated in place
    and returned). A tensor index keeps the decode step free of host syncs
    and of host-side shapes that change from step to step, so one CUDA
    graph replays it at every position."""
    check_supported(cfg)
    x, positions = embed_inputs(params["io"], cfg, batch)
    prefill = isinstance(cache, str) and cache == "init"
    decode = cache is not None and not prefill
    if decode:
        cache_index = torch.as_tensor(cache_index, device=x.device)
        if "positions" not in batch:
            # the single token sits at absolute position cache_index, in
            # each of M-RoPE's three streams
            B = x.shape[0]
            positions = (cache_index.view(1, 1, 1).expand(3, B, 1)
                         if cfg.mrope_sections else
                         cache_index.view(1, 1).expand(B, 1))
    # every layer's view of the stacked params, taken once: under autograd
    # unbind's backward stacks the layers' gradients once, where a select
    # per layer would write a zero tensor of the whole stack for each
    layers = _unstack(params["blocks"])
    caches = (_unstack(cache["blocks"]) if decode
              else ["init" if prefill else None] * len(layers))
    remat = (cfg.remat and not prefill and not decode
             and torch.is_grad_enabled())
    layer_caches = []
    delta = None
    aux_total: Dict[str, torch.Tensor] = {}
    for p, c in zip(layers, caches):
        if remat:
            x, delta, aux = checkpoint(_train_block, p, cfg, x, delta,
                                       positions, use_reentrant=False,
                                       preserve_rng_state=False)
            nc = None
        else:
            x, delta, nc, aux = apply_attn_block(p, cfg, x, delta, positions,
                                                 c, cache_index)
        layer_caches.append(nc)
        for key, v in aux.items():     # the reference's sum over layers
            aux_total[key] = aux_total[key] + v if key in aux_total else v
    new_cache = None
    if prefill:
        new_cache = {"blocks": tree_map(lambda *ts: torch.stack(ts),
                                        *layer_caches)}
    elif decode:
        new_cache = cache
    return x, delta, new_cache, aux_total


def _unstack(tree):
    """The list of per-layer trees of a tree stacked on a leading axis."""
    leaves = []
    tree_map(lambda t: leaves.append(t.unbind(0)), tree)
    out = []
    for per_layer in zip(*leaves):
        pieces = iter(per_layer)
        out.append(tree_map(lambda _: next(pieces), tree))
    return out


def _train_block(p, cfg: ModelConfig, x, delta, positions):
    """One training block for checkpoint: (x, delta, aux) out, so the
    recomputed forward routes as the forward did (torch.topk on the same
    inputs)."""
    x, delta, _, aux = apply_attn_block(p, cfg, x, delta, positions, None,
                                        None)
    return x, delta, aux


def apply_model(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache=None, cache_index=None, return_hidden=False):
    """Forward pass: (logits, new_cache, aux); cache and cache_index as in
    `apply_blocks`. With return_hidden, the final residual stream (x, delta)
    before the final norm takes the logits' place: x + delta is the
    reference's hidden state, and `unembed` folds the add into that norm
    (the chunked loss's path)."""
    x, delta, new_cache, aux = apply_blocks(params, cfg, batch, cache,
                                            cache_index)
    if return_hidden:
        return (x, delta), new_cache, aux
    return unembed(params["io"], cfg, x, delta), new_cache, aux
