"""Model assembly for every family: the attention stack (dense, MoE, VLM,
audio), xLSTM and the Mamba2 hybrid (zamba2) and pure-Mamba2 layouts.

Counterpart of ``repro.models.transformer``. The families:

  attention stack : n_layers blocks of attention + MLP, or attention + a
                    routed expert FFN (`models/moe.py`) in MoE configs. They
                    differ only in their io: token embeddings and a (tied
                    or separate) head; a VLM's precomputed patch embeddings
                    (``input_mode="embeddings"``) with (3, B, S) M-RoPE
                    positions; an audio model's codebook tokens (B, S, nq),
                    embedded by one table per codebook and summed, with one
                    head per codebook.
  xlstm           : g groups of (slstm_every - 1) mLSTM blocks and one
                    sLSTM block, then a tail of mLSTM blocks
                    (`xlstm_layout`; every block `models/ssm.py`'s).
  hybrid (zamba2) : n_seg segments of `shared_attn_every` Mamba2 blocks,
                    each followed by ONE shared attention + MLP block (the
                    same params every time), then a tail of Mamba2 blocks
                    (`zamba_layout`).
  mamba2          : n_layers Mamba2 blocks (an SSM config without
                    slstm_every, or a hybrid's LiteModel, whose
                    shared_attn_every is 0).
  zamba2          : Zamba2 as published, family "zamba2": its own module,
                    `models/zamba2.py`, to which `init_params`,
                    `init_cache` and `apply_blocks` hand it.

``init_params(gen, cfg, device)`` builds the parameter tree of the
reference, leaf for leaf: block params are stacked on a leading (n_layers,
...) axis, (g, m_per, ...) and (n_seg, seg, ...) for the grouped layouts,
so a tree converted from the reference's params
(`repro_torch.convert.params_from_numpy`) drops in. ``init_cache`` makes
the reference's decode cache, key for key. A Python loop over the layers
replaces ``lax.scan``.

Each residual add is folded into the norm that follows it: the loop carries
the residual stream and the pending delta (the attention's, the MLP's or an
SSM block's output), and `layers.apply_add_norm` adds and norms in one
step, which is one kernel launch (`add_rmsnorm`) for rmsnorm configs: a
block's second norm after its attention add, the next block's first norm
after its MLP or SSM add, and the final norm after the last block. Only the
first block's first norm is a plain norm. The arithmetic is the
reference's: the same add, in the same dtype, before the same norm.

With ``cfg.remat``, blocks run under
``torch.utils.checkpoint.checkpoint`` (non-reentrant) wherever autograd
records, where the reference wraps them in ``jax.checkpoint``: each
attention block, each mLSTM and each Mamba2 block of a stack, and each
zamba segment as a whole (its Mamba2 blocks and the shared block). The
reference does not wrap the sLSTM block, and neither does the port. A
checkpointed block keeps only its inputs for the backward and runs its
forward again there, its norm and flash kernels included.

An MoE block's aux losses (lb_loss, z_loss, dropped_frac) are summed over
the layers, as the reference sums them (so dropped_frac is a sum, not a
mean); every other model's aux is {}.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import apply_attention, init_attention
from repro_torch.models.layers import (apply_add_norm, apply_mlp,
                                       apply_norm, dense_init, embed_init,
                                       init_mlp, init_norm)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.utils.pytree import tree_map


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


def _norm_in(p, cfg: ModelConfig, x, delta):
    """(x + delta, its norm), or (x, norm(x)) when delta is None (the first
    block's first norm)."""
    if delta is None:
        return x, apply_norm(p, x, cfg.norm)
    return apply_add_norm(p, x, delta, cfg.norm)


def apply_attn_block(p, cfg: ModelConfig, x, delta, positions, cache,
                     cache_index):
    """One block on the residual stream x, whose pending delta (the block
    before's output; None for the first block) is added in this block's
    first norm. Returns (x, delta, new_cache, aux): the stream after the
    attention add, this block's MLP (or MoE) output as the next pending
    delta, and the MoE's aux losses ({} for an MLP)."""
    x, h = _norm_in(p["norm1"], cfg, x, delta)
    attn_out, new_cache = apply_attention(p["attn"], cfg, h, positions,
                                          cache, cache_index)
    x, h = apply_add_norm(p["norm2"], x, attn_out, cfg.norm)
    if cfg.is_moe:
        out, aux = apply_moe(p["moe"], cfg, h)
        return x, out, new_cache, aux
    return x, apply_mlp(p["mlp"], h, cfg.act), new_cache, {}


_SSM_INITS = {"mamba2": ssm.init_mamba2, "mlstm": ssm.init_mlstm,
              "slstm": ssm.init_slstm}
_SSM_APPLIES = {"mamba2": ssm.apply_mamba2, "mlstm": ssm.apply_mlstm,
                "slstm": ssm.apply_slstm}


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   device):
    return {"norm": init_norm(cfg.d_model, cfg.norm, cfg.dtype, device),
            "core": _SSM_INITS[kind](gen, cfg, device)}


def apply_ssm_block(p, cfg: ModelConfig, x, delta, kind: str, cache):
    """One SSM block (`kind` "mamba2", "mlstm" or "slstm") on the residual
    stream x and its pending delta, as `apply_attn_block`. Returns (x,
    delta, new_cache): the stream after the add, the block's output as the
    next pending delta, and the block's cache (see `models/ssm.py`)."""
    x, h = _norm_in(p["norm"], cfg, x, delta)
    out, new_cache = _SSM_APPLIES[kind](p["core"], cfg, h, cache)
    return x, out, new_cache


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
def xlstm_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mlstm_per_group, tail_mlstm). every `slstm_every`th =
    sLSTM."""
    if not cfg.slstm_every:
        return 0, 0, cfg.n_layers
    g = cfg.n_layers // cfg.slstm_every
    tail = cfg.n_layers - g * cfg.slstm_every
    return g, cfg.slstm_every - 1, tail


def zamba_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_segments, mamba2_per_segment, tail_mamba2)."""
    seg = cfg.shared_attn_every
    n_seg = cfg.n_layers // seg
    tail = cfg.n_layers - n_seg * seg
    return n_seg, seg, tail


def _grouped(tree, lead: Tuple[int, int]):
    """A tree stacked on (lead[0] * lead[1], ...) viewed as (*lead, ...)."""
    return tree_map(lambda t: t.view(lead + t.shape[1:]), tree)


def init_params(gen: torch.Generator, cfg: ModelConfig, device):
    if cfg.family == "zamba2":
        from repro_torch.models import zamba2
        return zamba2.init_params(gen, cfg, device)
    params: Dict[str, Any] = {"io": init_io(gen, cfg, device)}

    def blocks(n, kind):
        return _stack_init(n, lambda: init_ssm_block(gen, cfg, kind, device))

    if cfg.block_kind == "attention":
        params["blocks"] = _stack_init(
            cfg.n_layers, lambda: init_attn_block(gen, cfg, device))
    elif cfg.block_kind == "xlstm":
        g, m_per, tail = xlstm_layout(cfg)
        if g:
            params["mlstm"] = _grouped(blocks(g * m_per, "mlstm"),
                                       (g, m_per))
            params["slstm"] = blocks(g, "slstm")
        if tail:
            params["mlstm_tail"] = blocks(tail, "mlstm")
    elif cfg.shared_attn_every:              # hybrid (zamba2)
        n_seg, seg, tail = zamba_layout(cfg)
        params["mamba"] = _grouped(blocks(n_seg * seg, "mamba2"),
                                   (n_seg, seg))
        params["shared"] = init_attn_block(gen, cfg, device)
        if tail:
            params["mamba_tail"] = blocks(tail, "mamba2")
    else:                                    # pure Mamba2
        params["mamba"] = blocks(cfg.n_layers, "mamba2")
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               kv_split: Tuple[int, int] = (1, 1)):
    """Zeroed decode cache, the reference's keys, shapes and dtypes: an
    attention stack's {"blocks": {"k", "v": (L, B, kv_len, KV, hd)}} (kv_len
    the window for sliding-window configs: a ring buffer); xlstm's
    {"mlstm": {"C", "n", "m"} (g, m_per, ...), "slstm": {"h", "c", "n",
    "m"} (g, B, d), "mlstm_tail"}; zamba2's {"mamba": {"conv", "ssm"}
    (n_seg, seg, ...), "shared": {"k", "v"} (n_seg, ...), "mamba_tail"};
    pure Mamba2's {"mamba": (n_layers, ...)}. Recurrent states are fp32,
    the conv window and the KV cache cfg.dtype; each layout holds only the
    keys of the stacks it has. kv_split (batch shards, length shards) makes
    each KV cache this rank's (batch / dp, kv_len / model) slice, as the
    length-sharded decode (`models.attention.flash_decode_sharded`) holds
    it. Family "zamba2" takes `models/zamba2.py`'s (no kv_split)."""
    if cfg.family == "zamba2":
        from repro_torch.models import zamba2
        if kv_split != (1, 1):
            raise ValueError("zamba2's decode cache is not length-sharded")
        return zamba2.init_cache(cfg, batch, max_len, device)
    kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dp, shards = kv_split

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def attn_cache(lead):
        s = lead + (batch // dp, kv_len // shards, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
        return {"k": zeros(s, cfg.dtype), "v": zeros(s, cfg.dtype)}

    def mamba_cache(lead):
        d, inner, H, P, n = ssm.mamba2_dims(cfg)
        return {"conv": zeros(lead + (batch, cfg.ssm_conv - 1,
                                      ssm.mamba2_conv_dim(cfg)), cfg.dtype),
                "ssm": zeros(lead + (batch, H, n, P), torch.float32)}

    def mlstm_cache(lead):
        d, inner, H, P, Pk = ssm.mlstm_dims(cfg)
        return {"C": zeros(lead + (batch, H, Pk, P), torch.float32),
                "n": zeros(lead + (batch, H, Pk), torch.float32),
                "m": zeros(lead + (batch, H), torch.float32)}

    def slstm_cache(lead):
        return {k: zeros(lead + (batch, cfg.d_model), torch.float32)
                for k in ("h", "c", "n", "m")}

    if cfg.block_kind == "attention":
        return {"blocks": attn_cache((cfg.n_layers,))}
    c: Dict[str, Any] = {}
    if cfg.block_kind == "xlstm":
        g, m_per, tail = xlstm_layout(cfg)
        if g:
            c["mlstm"] = mlstm_cache((g, m_per))
            c["slstm"] = slstm_cache((g,))
        if tail:
            c["mlstm_tail"] = mlstm_cache((tail,))
        return c
    if cfg.shared_attn_every:
        n_seg, seg, tail = zamba_layout(cfg)
        c["mamba"] = mamba_cache((n_seg, seg))
        c["shared"] = attn_cache((n_seg,))
        if tail:
            c["mamba_tail"] = mamba_cache((tail,))
        return c
    return {"mamba": mamba_cache((cfg.n_layers,))}


class _Mode(NamedTuple):
    """How a forward runs: prefill builds the cache, decode updates it in
    place, remat checkpoints blocks (training under autograd)."""
    prefill: bool
    decode: bool
    remat: bool

    def caches(self, cache, n: int):
        """The n per-layer caches of a stacked decode cache (views, written
        in place), or n "init" markers (prefill) or Nones (training)."""
        if self.decode:
            return _unstack(cache)
        return ["init" if self.prefill else None] * n


def apply_blocks(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 cache=None, cache_index=None):
    """Embedding and blocks. Returns (x, delta, new_cache, aux): the final
    residual stream is x + delta, whose add `unembed` folds into the final
    norm; aux holds the MoE blocks' aux losses summed over the layers ({}
    for every other model).

    cache semantics: None = train; "init" = prefill (build the cache, the
    reference's keys and layout); a cache from `init_cache` = decode (S ==
    1 at position cache_index, an int or a 0-d int64 tensor on x's device;
    the cache, KV ring buffers and recurrent states alike, is updated in
    place and returned). A tensor index keeps the decode step free of host
    syncs and of host-side shapes that change from step to step, so one
    CUDA graph replays it at every position. Family "zamba2" runs
    `models/zamba2.py`'s layout (aux {})."""
    if cfg.family == "zamba2":
        from repro_torch.models import zamba2
        x, delta, new_cache = zamba2.apply_blocks(params, cfg, batch, cache,
                                                  cache_index)
        return x, delta, new_cache, {}
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
    mode = _Mode(prefill, decode, cfg.remat and not prefill and not decode
                 and torch.is_grad_enabled())
    aux: Dict[str, torch.Tensor] = {}
    if cfg.block_kind == "attention":
        x, delta, new_cache, aux = _attn_stack(
            params["blocks"], cfg, x, positions,
            cache["blocks"] if decode else None, cache_index, mode)
        if prefill:
            new_cache = {"blocks": new_cache}
    elif cfg.block_kind == "xlstm":
        x, delta, new_cache = _xlstm(params, cfg, x, cache, mode)
    else:
        x, delta, new_cache = _mamba(params, cfg, x, positions, cache,
                                     cache_index, mode)
    if decode:
        new_cache = cache
    return x, delta, new_cache, aux


def _stacked(caches):
    """Per-layer prefill caches stacked on a leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *caches)


def _attn_stack(blocks, cfg: ModelConfig, x, positions, cache, cache_index,
                mode: _Mode):
    """The attention blocks stacked in `blocks` on the stream x. Returns (x,
    delta, the stacked prefill cache or None, aux)."""
    # every layer's view of the stacked params, taken once: under autograd
    # unbind's backward stacks the layers' gradients once, where a select
    # per layer would write a zero tensor of the whole stack for each
    layers = _unstack(blocks)
    layer_caches = []
    delta = None
    aux_total: Dict[str, torch.Tensor] = {}
    for p, c in zip(layers, mode.caches(cache, len(layers))):
        if mode.remat:
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
    return (x, delta, _stacked(layer_caches) if mode.prefill else None,
            aux_total)


def _ssm_stack(blocks, cfg: ModelConfig, kind: str, x, delta, cache,
               mode: _Mode):
    """The SSM blocks of one `kind` stacked in `blocks` on the stream (x,
    delta), each under checkpoint with remat. Returns (x, delta, the
    stacked prefill cache or None)."""
    layers = _unstack(blocks)
    layer_caches = []
    for p, c in zip(layers, mode.caches(cache, len(layers))):
        if mode.remat:
            x, delta = checkpoint(_train_ssm_block, p, cfg, kind, x, delta,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, delta, c = apply_ssm_block(p, cfg, x, delta, kind, c)
        layer_caches.append(c)
    return x, delta, _stacked(layer_caches) if mode.prefill else None


def _xlstm(params, cfg: ModelConfig, x, cache, mode: _Mode):
    """xLSTM's groups (m_per mLSTM blocks, then one sLSTM block, which no
    checkpoint wraps, as in the reference), then its mLSTM tail. Returns
    (x, delta, the prefill cache {"mlstm", "slstm", "mlstm_tail"} or
    None)."""
    g, m_per, tail = xlstm_layout(cfg)
    out: Dict[str, Any] = {}
    delta = None
    if g:
        m_groups = _unstack(params["mlstm"])
        s_layers = _unstack(params["slstm"])
        m_caches = (_unstack(cache["mlstm"]) if mode.decode
                    else [None] * g)
        s_caches = mode.caches(cache["slstm"] if mode.decode else None, g)
        mcs, scs = [], []
        for mp, sp, mc, sc in zip(m_groups, s_layers, m_caches, s_caches):
            x, delta, mc = _ssm_stack(mp, cfg, "mlstm", x, delta, mc, mode)
            x, delta, sc = apply_ssm_block(sp, cfg, x, delta, "slstm", sc)
            mcs.append(mc)
            scs.append(sc)
        if mode.prefill:
            out["mlstm"], out["slstm"] = _stacked(mcs), _stacked(scs)
    if tail:
        x, delta, out["mlstm_tail"] = _ssm_stack(
            params["mlstm_tail"], cfg, "mlstm", x, delta,
            cache["mlstm_tail"] if mode.decode else None, mode)
    return x, delta, out if mode.prefill else None


def _mamba(params, cfg: ModelConfig, x, positions, cache, cache_index,
           mode: _Mode):
    """zamba2's segments (seg Mamba2 blocks, then the shared attention + MLP
    block; with remat each segment under one checkpoint) and its Mamba2
    tail, or a pure Mamba2 stack. Returns (x, delta, the prefill cache
    {"mamba", "shared", "mamba_tail"} or {"mamba"}, or None)."""
    out: Dict[str, Any] = {}
    if not cfg.shared_attn_every:
        x, delta, out["mamba"] = _ssm_stack(
            params["mamba"], cfg, "mamba2", x, None,
            cache["mamba"] if mode.decode else None, mode)
        return x, delta, out if mode.prefill else None
    n_seg, seg, tail = zamba_layout(cfg)
    shared = params["shared"]
    segs = _unstack(params["mamba"])
    m_caches = _unstack(cache["mamba"]) if mode.decode else [None] * n_seg
    s_caches = mode.caches(cache["shared"] if mode.decode else None, n_seg)
    inner = mode._replace(remat=False)
    delta = None
    mcs, scs = [], []
    for mp, mc, sc in zip(segs, m_caches, s_caches):
        if mode.remat:
            x, delta = checkpoint(_train_segment, mp, shared, cfg, x, delta,
                                  positions, use_reentrant=False,
                                  preserve_rng_state=False)
            continue
        x, delta, mc = _ssm_stack(mp, cfg, "mamba2", x, delta, mc, inner)
        x, delta, sc, _ = apply_attn_block(shared, cfg, x, delta, positions,
                                           sc, cache_index)
        mcs.append(mc)
        scs.append(sc)
    if mode.prefill:
        out["mamba"], out["shared"] = _stacked(mcs), _stacked(scs)
    if tail:
        x, delta, out["mamba_tail"] = _ssm_stack(
            params["mamba_tail"], cfg, "mamba2", x, delta,
            cache["mamba_tail"] if mode.decode else None, mode)
    return x, delta, out if mode.prefill else None


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


def _train_ssm_block(p, cfg: ModelConfig, kind: str, x, delta):
    """One training SSM block for checkpoint: (x, delta) out."""
    x, delta, _ = apply_ssm_block(p, cfg, x, delta, kind, None)
    return x, delta


def _train_segment(mp, shared, cfg: ModelConfig, x, delta, positions):
    """One training zamba segment for checkpoint: its Mamba2 blocks, then
    the shared attention + MLP block; (x, delta) out."""
    for p in _unstack(mp):
        x, delta, _ = apply_ssm_block(p, cfg, x, delta, "mamba2", None)
    x, delta, _, _ = apply_attn_block(shared, cfg, x, delta, positions,
                                      None, None)
    return x, delta


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
