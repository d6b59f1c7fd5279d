"""Serving path: prefill + single-token greedy decode with KV and SSM-state
caches.

Counterpart of ``repro.serve.engine`` for every family of
`repro_torch.models.transformer`: dense, MoE, VLM, audio, xLSTM, the
zamba2 hybrid and pure Mamba2. Sliding-window configs keep a ring-buffer
cache of window size; SSM and hybrid configs keep O(1) recurrent state,
which the decode step updates in place. An audio
model decodes the (B, nq) argmax of its per-codebook logits as the next
step's codebook tokens; a VLM feeds the next step the embedding rows of
its argmax tokens, as the reference does.

Where the reference compiles its decode step with ``jax.jit``, the port
runs it on the card as one CUDA graph: `ServeEngine` captures the step once
per batch size, at the first `generate` of that size, and replays it for
every token. The step reads its token, its position (a 0-d device tensor)
and the cache from static buffers and writes the next token back into its
token buffer, so a replay needs no host work beyond setting the position.
On the CPU the same step runs eagerly on the same buffers. Prefill stays
eager.

Phase spans (`repro_torch.obs.trace.phase`; off unless a tracer or a
profiler records them): ``serve.generate`` around a call, with the decode
cache's state and KV bytes and the call's decode-attention launches as its
args, and on a card the caching allocator's device mallocs and retries
during it; ``serve.prefill`` around
the prefill and ``serve.replay`` around each decode step.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import (decode_attention, flash_attention, kd_loss,
                                 rmsnorm)
from repro_torch.launch.axes import current_mesh
from repro_torch.models.api import (decode_step as _decode,
                                    make_decode_cache, prefill as _prefill)
from repro_torch.models.attention import decode_shards
from repro_torch.obs.trace import phase
from repro_torch.utils.device import resolve_device

#: every kernel wrapper's launch counts
_COUNTERS = (flash_attention.launches, kd_loss.launches, rmsnorm.launches,
             decode_attention.launches)


def _launch_counts() -> Dict[str, int]:
    return {k: n for c in _COUNTERS for k, n in c.items()}


def _add_launches(delta: Dict[str, int]) -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] += delta.get(k, 0)


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


def decode_batch(cfg: ModelConfig, params, tokens: torch.Tensor):
    """The decode step's batch for the new tokens (B, 1[, nq]): the tokens,
    or for a VLM their rows of params["io"]["embed"] as (B, 1, d)
    embeddings in cfg.dtype."""
    if cfg.input_mode == "embeddings":
        return {"embeddings": params["io"]["embed"][tokens].to(cfg.dtype)}
    return {"tokens": tokens}


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


def _load_prefill(big, small, path=(), carry: bool = False) -> None:
    """Zero the decode cache `big` and copy the prefill cache `small` into
    it, leaf paired with leaf by key at every level, as the reference's
    ``tree_map(cache, pre_cache)`` pairs them: a leaf of another shape is
    written at the origin (`_write_prefix`); a leaf of the same shape is
    left zero, as the reference leaves it (`ServeEngine.generate`), unless
    `carry`, which copies it (a recurrent state: the prompt's). Raises
    ValueError where the two trees' keys differ."""
    if isinstance(big, dict) or isinstance(small, dict):
        if not (isinstance(big, dict) and isinstance(small, dict)
                and set(big) == set(small)):
            keys = [sorted(t) if isinstance(t, dict) else type(t).__name__
                    for t in (big, small)]
            raise ValueError(f"the prefill cache at {list(path)} does not "
                             f"pair with the decode cache: keys {keys[1]} "
                             f"against {keys[0]}")
        for key in big:
            _load_prefill(big[key], small[key], path + (key,), carry)
        return
    if big.shape != small.shape:
        big.zero_()
        _write_prefix(big, small)
    elif carry:
        big.copy_(small)
    else:
        big.zero_()


def cache_bytes(cache) -> Dict[str, int]:
    """Bytes of a decode cache: "kv_bytes" its KV leaves (those under a
    {"k", "v"} dict), "state_bytes" every other leaf (recurrent states)."""
    out = {"state_bytes": 0, "kv_bytes": 0}

    def walk(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict):
                walk(leaf)
            else:
                key = "kv_bytes" if set(tree) == {"k", "v"} else "state_bytes"
                out[key] += leaf.numel() * leaf.element_size()
    walk(cache)
    return out


class _DecodeStep:
    """The decode step of one batch size on static buffers: the token
    (B, 1), or (B, 1, nq) for an audio model, the position (0-d int64) and
    the decode cache. On CUDA it is captured into a CUDA graph after one
    eager warm-up step on a side stream; a failed capture raises."""

    def __init__(self, decode, params, cfg: ModelConfig, batch: int,
                 max_len: int, device: torch.device):
        if decode_shards(cfg, current_mesh()) > 1:
            # its collectives are gloo's where ranks share a card, and a
            # gloo collective cannot be captured in a CUDA graph; the
            # engine's prefill load also writes a whole cache
            raise RuntimeError(
                "ServeEngine does not run the length-sharded decode of the "
                "current mesh; drive it through models.api.decode_step")
        shape = (batch, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
        self.tokens = torch.zeros(shape, dtype=torch.int64, device=device)
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        self.cache = make_decode_cache(cfg, batch, max_len, device)
        self.cache_bytes = cache_bytes(self.cache)
        self.graph = None
        self.logits = None
        self.launches: Dict[str, int] = {}   # per replay

        # the buffers, not self: a closure over self would make a reference
        # cycle, and the engine's params and cache would outlive `del
        # engine` until the garbage collector ran
        tokens, index, cache = self.tokens, self.index, self.cache

        def run():
            tok, logits, _ = decode(params, decode_batch(cfg, params, tokens),
                                    cache, index)
            tokens.copy_(tok[:, None])
            return logits
        self._run = run
        if device.type == "cuda":
            self._capture(device)

    def _capture(self, device: torch.device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()     # warm-up: lazy cuBLAS and allocator set-up
        torch.cuda.current_stream(device).wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self._run()
        after = _launch_counts()
        # the wrappers counted their launches while being captured, but
        # nothing ran: the count moves from the capture to every replay
        self.launches = {k: after[k] - before[k] for k in after}
        _add_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph

    def step(self) -> torch.Tensor:
        """One step at the position in `index`; returns its logits (B, 1[,
        nq], vocab), a buffer that the next step overwrites."""
        with phase("serve.replay"):
            if self.graph is None:
                self.logits = self._run()
            else:
                self.graph.replay()
        _add_launches(self.launches)
        return self.logits


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
        self._steps: Dict[int, _DecodeStep] = {}

    def decode_step_for(self, batch: int) -> _DecodeStep:
        """The static decode step of `batch` rows (captured on CUDA at the
        first call)."""
        st = self._steps.get(batch)
        if st is None:
            st = self._steps[batch] = _DecodeStep(
                self._decode, self.params, self.cfg, batch, self.max_len,
                self.device)
        return st

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor], n_new: int = 16,
                 return_logits: bool = False, return_first: bool = False):
        """batch {"tokens": (B, S)}, an audio model's {"tokens": (B, S, nq)}
        or a VLM's {"embeddings": (B, S, d), "positions": (3, B, S)}
        (tensors or numpy arrays) -> (B, n_new[, nq]) numpy array of greedy
        tokens; with return_logits, also each step's logits, (B, n_new[,
        nq], vocab) fp32 on the device; with return_first, last, the
        argmax of the prompt's last position, (B[, nq]) numpy.

        As in the reference, the argmax of the prefill logits is fed to the
        first decode step but not returned unless asked for: the result is
        the n_new decode argmaxes. The prefill cache is paired with the
        decode cache key by key (a different key set raises ValueError).
        Also as in the reference, a prefill cache leaf of exactly the
        decode cache leaf's shape (prompt length == max_len, or == the
        sliding window) is not copied into the decode cache, which decode
        then reads as zeros (ROADMAP §3). Every recurrent-state leaf has
        the same shape in prefill and decode, so for the SSM and hybrid
        families the prompt's state is dropped and decode starts from a
        zero state: of an xLSTM's or a pure Mamba2's prefill cache nothing
        is carried over, and of zamba2's only the shared attention block's
        KV cache. A config with `carry_prompt_state` (Zamba2 as published)
        copies every such leaf instead, so its decode continues from the
        prompt's state. `models.api.prefill` and `decode_step` carry the
        state too.

        A recorded ``serve.generate`` span carries, besides the
        allocator's counts, the decode cache's "state_bytes" and
        "kv_bytes" (`cache_bytes`) and the call's "decode_attention"
        kernel launches (each attention call of each decode step; 0 on the
        CPU)."""
        with phase("serve.generate") as span:
            counts = (_alloc_counts(self.device) if span.recording
                      else None)
            attn = decode_attention.launches["decode_attention"]
            out = self._generate(batch, n_new, return_logits, return_first,
                                 span)
            if counts is not None:
                span.args.update(
                    (k, n - counts[k])
                    for k, n in _alloc_counts(self.device).items())
                span.args["decode_attention"] = (
                    decode_attention.launches["decode_attention"] - attn)
        return out

    def _generate(self, batch, n_new, return_logits, return_first, span):
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        prompt = batch["embeddings" if self.cfg.input_mode == "embeddings"
                       else "tokens"]
        B, prompt_len = prompt.shape[:2]
        with phase("serve.prefill"):
            logits, pre_cache = self._prefill(self.params, batch)
        st = self.decode_step_for(B)
        if span.recording:
            span.args.update(st.cache_bytes)
        _load_prefill(st.cache, pre_cache, carry=self.cfg.carry_prompt_state)
        del pre_cache
        st.tokens.copy_(logits[:, -1].argmax(-1)[:, None])
        first = int(return_first)       # column 0 holds the prompt's argmax
        out = torch.empty((B, first + n_new) + st.tokens.shape[2:],
                          dtype=torch.int64, device=self.device)
        if return_first:
            out[:, 0] = st.tokens[:, 0]
        kept = (torch.empty((B, n_new) + logits.shape[2:], dtype=logits.dtype,
                            device=self.device) if return_logits else None)
        for i in range(n_new):
            st.index.fill_(prompt_len + i)
            step_logits = st.step()
            out[:, first + i] = st.tokens[:, 0]
            if kept is not None:
                kept[:, i] = step_logits[:, -1]
        toks = out.cpu().numpy()
        if not (return_logits or return_first):
            return toks
        return ((toks[:, first:],) + ((kept,) if return_logits else ())
                + ((toks[:, 0],) if return_first else ()))


def _alloc_counts(device: torch.device) -> Dict[str, int]:
    """The caching allocator's device mallocs and retries so far on a card
    (host-side counters; no sync), {} on the CPU."""
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"mallocs": s.get("num_device_alloc", 0),
            "alloc_retries": s.get("num_alloc_retries", 0)}
