"""GQA attention: flash-kernel training/prefill + KV-cache decode.

Counterpart of ``repro.models.attention``. Training and prefill (more than
one new token, or building the cache) go through the port's flash-attention
wrapper (`repro_torch.kernels.ops.flash_attention_op`): the CUDA kernel on the
card, which takes the (B, S, H, hd) projections as transposed views with no
copy, and its plain version on the CPU. Decode (one new token against a cache)
writes the token's k/v into the ring-buffer cache and attends through the
decode-attention wrapper (`repro_torch.kernels.ops.decode_attention_op`):
on the card a CUDA kernel that reads the cache in place over the filled
slots only, on the CPU the reference's call, `gqa_attention` (plain
PyTorch, `kernels/ref.py`) over the whole cache under its mask. Both take
the position as a 0-d device tensor, so the step's shapes do not change
from step to step.

The decode step updates the cache tensors it is given in place (the
reference returns new arrays), so a (B, L, KV, hd) cache is never copied.

Under a mesh whose "model" axis does not divide n_kv_heads (the reference's
condition; `decode_shards`), the decode runs `flash_decode_sharded` instead:
each rank holds its L / model slice of the cache (and its share of the
batch over the mesh's batch axes), which `models.api.make_decode_cache`
allocates, and the ranks combine their softmax partials over the model
axis's group. That body is the reference's jnp, outside any Pallas kernel,
so it is plain PyTorch here too.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import decode_attention_op, flash_attention_op
from repro_torch.kernels.ref import NEG_INF, gqa_attention  # noqa: F401
from repro_torch.launch.axes import current_mesh, current_rules
from repro_torch.launch.mesh import all_gather_rows, all_reduce_, axis_sizes
from repro_torch.models.layers import apply_rope, dense_init


def _batch_spec_axes(mesh, batch: int):
    """The mesh axes of the "batch" rule, in order, that split `batch` rows
    evenly (each taken while the product so far still divides it)."""
    sizes = axis_sizes(mesh)
    axes, prod = [], 1
    for a in current_rules().get("batch", ()):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def decode_shards(cfg: ModelConfig, mesh) -> int:
    """The number of slices the decode KV cache's length is split into
    under `mesh`: the "model" axis size where it does not divide
    n_kv_heads (the reference's flash-decode condition), else 1."""
    if mesh is None:
        return 1
    m = axis_sizes(mesh).get("model", 1)
    return m if cfg.n_kv_heads % m else 1


def batch_shards(mesh, batch: int) -> int:
    """The number of slices the batch of a length-sharded KV cache is split
    into: the product of `_batch_spec_axes`."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _batch_spec_axes(mesh, batch))


def flash_decode_sharded(q, cache_k, cache_v, k_new, v_new, slot, kv_valid,
                         mesh):
    """One-token decode attention over a LENGTH-sharded KV cache, the ring
    buffer's write included: counterpart of the reference's
    ``flash_decode_shardmap``.

    q / k_new / v_new: (B, 1, H | KV, hd), every rank's whole batch;
    cache_k / cache_v: this rank's (B / dp, L / model, KV, hd) slice, its
    rows of the batch over the batch axes (`_batch_spec_axes`) and its
    slots [i Ls, (i + 1) Ls) for model coordinate i, updated in place;
    slot, kv_valid: 0-d int64 tensors. Only the rank that owns the slot
    changes its slice. Each rank computes its softmax partials (m, l, o) in
    fp32; all_reduce(MAX) of m and all_reduce(SUM) of l w and o w, w =
    exp(m - m_g), over the model axis combine them. Returns (B, 1, H, hd) in
    q's dtype, gathered over the batch axes."""
    B, _, H, hd = q.shape
    Bs, Ls, KV, _ = cache_k.shape
    G = H // KV
    rows = _rank_rows(mesh, B, Bs)
    idx = mesh.get_local_rank("model")
    pos = idx * Ls + torch.arange(Ls, device=q.device)     # global slots
    # ring-buffer write: the owner writes the new k/v at its local slot;
    # the others write back what their (clamped) slot holds
    owner = (slot >= idx * Ls) & (slot < (idx + 1) * Ls)
    local = (slot - idx * Ls).clamp(0, Ls - 1).view(1)
    for c, new in ((cache_k, k_new[rows]), (cache_v, v_new[rows])):
        c.index_copy_(1, local, torch.where(owner, new.to(c.dtype),
                                            c.index_select(1, local)))
    qh = q[rows].reshape(Bs, KV, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qh, cache_k.float()) * (
        1.0 / math.sqrt(hd))
    s = s.masked_fill(~(pos < kv_valid), NEG_INF)
    m = s.amax(-1, keepdim=True)                          # (Bs, KV, G, 1)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgt,btkh->bkgh", p, cache_v.float())
    m_g = all_reduce_(m.clone(), dist.ReduceOp.MAX, mesh, "model")
    w = torch.exp(m - m_g)
    l_g = all_reduce_(l * w, dist.ReduceOp.SUM, mesh, "model")
    o_g = all_reduce_(o * w, dist.ReduceOp.SUM, mesh, "model")
    out = (o_g / l_g.clamp(min=1e-30)).reshape(Bs, 1, H, hd).to(q.dtype)
    for a in reversed(_batch_spec_axes(mesh, B)):   # innermost axis first
        out = all_gather_rows(out, mesh, a)
    return out


def _rank_rows(mesh, batch: int, rows: int) -> slice:
    """This rank's `rows` of `batch` under the batch axes: its block's index
    is its coordinates on those axes, the last the fastest."""
    sizes = axis_sizes(mesh)
    blk = 0
    for a in _batch_spec_axes(mesh, batch):
        blk = blk * sizes[a] + mesh.get_local_rank(a)
    return slice(blk * rows, (blk + 1) * rows)


def fill_kv_slice(big, small, mesh, shards: int) -> None:
    """Zero `big` (..., Bs, Ls, KV, hd), this rank's slice of an L = Ls
    shards slot ring buffer, and write the prompt's k or v `small` (..., B,
    S, KV, hd) into it: position t at slot t % L, for the last L positions;
    under `mesh` (None: the whole cache) only the slots [i Ls, (i + 1) Ls)
    of model coordinate i and this rank's batch rows."""
    B, S = small.shape[-4:-2]
    Bs, Ls = big.shape[-4:-2]
    L = Ls * shards
    first, rows = 0, slice(0, B)
    if mesh is not None:
        first = mesh.get_local_rank("model") * Ls
        rows = _rank_rows(mesh, B, Bs)
    t = torch.arange(max(S - L, 0), S, device=big.device)
    slot = t % L
    mine = (slot >= first) & (slot < first + Ls)
    big.zero_()
    dim = big.dim() - 3
    big.index_copy_(dim, slot[mine] - first,
                    small[..., rows, :, :, :].index_select(
                        dim, t[mine]).to(big.dtype))


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


def apply_attention(params, cfg: ModelConfig, x, positions,
                    cache=None, cache_index=None, scale=None,
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). cache: None (train), "init" (prefill: the layer's k, v
    come back as its cache) or {"k", "v": (B, L, KV, hd)} with S == 1
    (decode at position cache_index, a 0-d int64 tensor: the token's k, v
    are written at slot cache_index % L, in place, and the query attends
    over the min(cache_index + 1, L) slots filled so far). Scores are
    scaled by 1/sqrt(hd), or by `scale` where given (Zamba2's shared
    block: (hd / 2)^-0.5, whose decode cache is never length-sharded).

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
        # (one CUDA graph replays it). The query attends over the
        # min(cache_index + 1, L) slots filled so far: on the card the
        # kernel reads only those, read from the device's position; on the
        # CPU the plain version attends over all L under the reference's
        # mask.
        mesh = current_mesh()
        shards = decode_shards(cfg, mesh)
        L = cache["k"].shape[1] * shards
        if shards > 1:
            out = flash_decode_sharded(q, cache["k"], cache["v"], k, v,
                                       cache_index % L,
                                       torch.clamp(cache_index + 1, max=L),
                                       mesh)
        else:
            slot = (cache_index % L).view(1)
            cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            out = decode_attention_op(q, cache["k"], cache["v"], cache_index,
                                      scale=scale)
        new_cache = cache
    else:
        # (B, H, S, hd) views: the kernel reads them through their strides,
        # and its output transposed back is (B, S, H, hd) contiguous on the
        # card, so the reshape below is a view there
        out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 sliding_window=cfg.sliding_window,
                                 scale=scale)
        out = out.transpose(1, 2)
        if cache is not None:  # prefill ("init" marker): emit cache
            new_cache = {"k": k, "v": v}
    out = out.reshape(B, S, cfg.n_heads * hd)
    return out @ params["wo"], new_cache
