"""Serving path: prefill + single-token greedy decode with a KV cache.

Counterpart of ``repro.serve.engine`` for the dense decoders the port has
(`repro_torch.models.transformer`). Sliding-window configs keep a
ring-buffer cache of window size.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import (decode_step as _decode,
                                    make_decode_cache, prefill as _prefill)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return _prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch, cache, cache_index):
        logits, new_cache = _decode(params, cfg, batch, cache, cache_index)
        next_tok = logits[:, -1].argmax(-1)
        return next_tok, logits, new_cache
    return decode_step


def _write_prefix(big: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """big with small written at its origin (the reference's
    dynamic_update_slice at index 0), in place."""
    if small.dim() != big.dim() or any(s > b for s, b in
                                       zip(small.shape, big.shape)):
        raise ValueError(f"a prefill cache {tuple(small.shape)} does not fit "
                         f"the decode cache {tuple(big.shape)}: the prompt "
                         f"is longer than max_len or the sliding window")
    big[tuple(slice(0, s) for s in small.shape)] = small.to(big.dtype)
    return big


class ServeEngine:
    """Small batched-request serving loop (greedy decode) on `device` (CUDA
    when None); params must already live there."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor], n_new: int = 16):
        """batch {"tokens": (B, S)} (tensors or numpy arrays) -> (B, n_new)
        numpy array of greedy tokens.

        As in the reference, the argmax of the prefill logits is fed to the
        first decode step but not returned: the result is the n_new decode
        argmaxes. Also as in the reference, a prefill cache of exactly the
        decode cache's shape (prompt length == max_len, or == the sliding
        window) is not copied into the decode cache (ROADMAP §3)."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        B = tree_leaves(batch)[0].shape[0]
        prompt_len = batch["tokens"].shape[1]
        logits, pre_cache = self._prefill(self.params, batch)
        cache = make_decode_cache(self.cfg, B, self.max_len, self.device)
        cache = tree_map(lambda big, small: (big if big.shape == small.shape
                                             else _write_prefix(big, small)),
                         cache, pre_cache)
        del pre_cache
        toks = []
        tok = logits[:, -1].argmax(-1)
        for i in range(n_new):
            tok, logits, cache = self._decode(self.params,
                                              {"tokens": tok[:, None]},
                                              cache, prompt_len + i)
            toks.append(tok)
        return torch.stack(toks, dim=1).cpu().numpy()
