"""Public model API: build and apply any of the assigned architectures by
config (dense, MoE, VLM, audio, xLSTM, the zamba2 hybrid and pure Mamba2).

Counterpart of ``repro.models.api``. Entry points that make tensors run on
CUDA unless the caller passes a device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.axes import current_mesh
from repro_torch.models.attention import (batch_shards, decode_shards,
                                          fill_kv_slice)
from repro_torch.models.transformer import (apply_blocks, apply_model,
                                            init_cache, init_params, unembed)
from repro_torch.utils.device import resolve_device


def init_model(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Params of `cfg` drawn from `gen`, which must live on `device` (CUDA
    when None)."""
    return init_params(gen, cfg, resolve_device(device))


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Training forward: logits (fp32), aux losses (an MoE model's
    lb_loss, z_loss and dropped_frac, each summed over its layers; {} for
    every other model)."""
    logits, _, aux = apply_model(params, cfg, batch, cache=None)
    return logits, aux


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Prefill: consume a prompt, return (last-token logits, cache): the
    layers' KV caches, and an SSM's or hybrid's recurrent states after the
    prompt, under `init_cache`'s keys. Only the last position is
    unembedded: rows are independent, so its logits are those of the full
    unembedding, and the (B, S, vocab) fp32 logits are never made. The
    final residual add, folded into the final norm, runs on the last
    position too."""
    x, delta, cache, _ = apply_blocks(params, cfg, batch, cache="init")
    return unembed(params["io"], cfg, x[:, -1:], delta[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache, cache_index):
    """One decode step at position cache_index (an int, or a 0-d int64
    tensor on the cache's device, which a CUDA graph can replay). batch
    holds the single new token (B, 1[, nq]), or a VLM's (B, 1, d)
    embeddings; the cache (KV ring buffers and recurrent states) is updated
    in place and returned."""
    logits, new_cache, _ = apply_model(params, cfg, batch, cache=cache,
                                       cache_index=cache_index)
    return logits, new_cache


def make_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """The zeroed decode cache (`init_cache`). Under a current mesh
    (`launch.axes.use_axis_rules`) on which the decode is length-sharded
    (`models.attention.decode_shards`), each KV cache is this rank's slice:
    (batch / dp, kv_len / model) with dp the batch axes' product; kv_len
    must then divide by the model axis."""
    mesh = current_mesh()
    shards = decode_shards(cfg, mesh)
    split = (1, 1)
    if shards > 1:
        kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                  else max_len)
        if kv_len % shards:
            raise ValueError(f"the length-sharded decode splits the KV "
                             f"cache's {kv_len} slots over the model axis "
                             f"of {shards}: they must divide")
        split = (batch_shards(mesh, batch), shards)
    return init_cache(cfg, batch, max_len, resolve_device(device), split)


def fill_decode_cache(cfg: ModelConfig, cache, prefill_cache) -> None:
    """Write a prefill cache into a decode cache made by `make_decode_cache`,
    in place, leaf paired with leaf by key: a KV cache {"k", "v": (..., B,
    S, KV, hd)} goes to the ring buffer's slots (position t at slot t % L;
    the last L positions of a longer prompt), under a length-sharded mesh
    only the slots and batch rows of this rank's slice; every other leaf (a
    recurrent state) is copied. Unlike `ServeEngine.generate`, which mirrors
    the reference's engine, this keeps the prompt's whole state."""
    mesh = current_mesh()
    shards = decode_shards(cfg, mesh)
    _fill(cache, prefill_cache, mesh if shards > 1 else None, shards)


def _fill(big, small, mesh, shards: int) -> None:
    for key, leaf in big.items():
        if isinstance(leaf, dict):
            _fill(leaf, small[key], mesh, shards)
        elif set(big) == {"k", "v"}:
            fill_kv_slice(leaf, small[key], mesh, shards)
        else:
            leaf.copy_(small[key])


def dummy_batch(cfg: ModelConfig, batch: int, seq: int,
                gen: Optional[torch.Generator] = None,
                with_labels: bool = True,
                device=None) -> Dict[str, torch.Tensor]:
    """A batch of the config's structure, drawn from `gen` (seed 0 on
    `device` when None): random tokens (B, S), or (B, S, nq) for an audio
    model; for a VLM, N(0, 1) embeddings (B, S, d) in cfg.dtype and the
    reference's (3, B, S) M-RoPE positions (t, t // 8, t % 8). Labels are
    tokens of the tokens' shape ((B, S) for a VLM)."""
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
    shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, seq))
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=gen,
                                        device=device).to(cfg.dtype)
        t = torch.arange(seq, dtype=torch.int32,
                         device=device)[None].expand(batch, seq)
        out["positions"] = torch.stack([t, t // 8, t % 8])
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=device)
    if with_labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=device)
    return out
