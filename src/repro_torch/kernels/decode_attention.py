"""One-token decode attention over a KV cache on Hopper: the wrapper, how
many warps split each KV head's filled slots, and its launch count.

The CUDA kernels in ``csrc/decode_attention.cu`` replace no Pallas kernel
(the JAX package's decode is plain jnp); that file's header says what
bounds them (bytes: K and V over the filled slots, once) and how they are
laid out. They read the (B, L, KV, hd) caches in place through their
strides, only over the kv_valid = min(cache_index + 1, L) slots filled so
far, which they derive on the card from the 0-d position tensor, so a
call needs no host sync and one CUDA graph replays it at every position.

The plain version (`ref.decode_attention_ref`, the reference's
`gqa_attention` call over the whole cache under its mask) is what CPU
tensors take. CUDA tensors launch the kernels or raise. Meta tensors (the
dry run) return an empty output and record the kernels' work over all L
slots (`kernels.cost`), launching nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build, cost, ref

#: kernel launches; the wrapper adds one where it launches its kernel and
#: nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"decode_attention": 0}

#: head dims the kernels are instantiated for
HEAD_DIMS = (64, 112, 128, 224)

#: slots a pipeline stage holds (``csrc/decode_attention.cu``'s kChunk)
CHUNK = 16

#: query rows one block serves (``csrc/decode_attention.cu``'s kRows); a KV
#: head of G query heads takes ceil(G / ROWS) blocks
ROWS = 8

#: warps a block, at most (``csrc/decode_attention.cu``'s kMaxWarps): each
#: takes one part of the filled slots
MAX_WARPS = 8

#: the fewest slots a part takes where the cache is full
MIN_PART = 4 * CHUNK

#: warps past which an SM streams the caches no faster (measured on an
#: H100: the MoE serve cell's decode took as long at 4 to 8 warps a block,
#: one block an SM)
SATURATE = 4

#: query heads a KV head may serve
MAX_GROUP = 64

#: (device, hd, G, dtype) -> blocks of 1 .. MAX_WARPS warps the card holds
#: at once
_fits: Dict[Tuple, Tuple[int, ...]] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention.argtypes = [
            P, P, P, P, P, I, I, I, I, I,
            ctypes.POINTER(ctypes.c_longlong), I, ctypes.c_float, I, P]
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_blocks_per_sm.argtypes = [I, I, I, I]
        lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
    return lib


def warps(fits: Sequence[int], pairs: int, L: int) -> int:
    """W, the warps of a block, each taking one of W parts of a KV head's
    filled slots, for `pairs` blocks (b, KV head, row tile) on a card that
    holds fits[W - 1] blocks of W warps at once (0: such a block does not
    fit): the W up to MAX_WARPS and L / MIN_PART that finishes soonest, a
    wave of blocks taking 1 / min(W, SATURATE) (past SATURATE warps an SM
    streams no faster) and the blocks taking ceil(pairs / fits[W - 1])
    waves; a larger W only where that saves 2% or more. Fixed by the shapes
    and the card, so every position runs one grid."""
    best, cost_best = None, None
    for W in range(1, min(MAX_WARPS, max(1, L // MIN_PART)) + 1):
        if fits[W - 1] <= 0:
            continue
        cost = math.ceil(pairs / fits[W - 1]) / min(W, SATURATE)
        if cost_best is None or cost < 0.98 * cost_best:
            best, cost_best = W, cost
    if best is None:
        raise RuntimeError("decode_attention: no block of one warp fits")
    return best


def fits(device: torch.device, hd: int, G: int,
         dtype: torch.dtype) -> Tuple[int, ...]:
    """Blocks of 1 .. MAX_WARPS warps of the kernel for (hd, G, dtype) that
    `device` holds at once: its SMs times the occupancy API's blocks an SM
    (0 where a block's shared memory exceeds an SM's)."""
    key = (device, hd, G, dtype)
    if key not in _fits:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out = []
        with torch.cuda.device(device):
            for W in range(1, MAX_WARPS + 1):
                per_sm = _lib().decode_attention_blocks_per_sm(
                    hd, G, _build.DTYPE_CODE[dtype], W)
                if per_sm < 0:
                    raise RuntimeError(f"decode_attention: the occupancy of "
                                       f"{W} warps at hd {hd}, G {G}, "
                                       f"{dtype} failed (CUDA error "
                                       f"{-per_sm})")
                out.append(per_sm * sms)
        _fits[key] = tuple(out)
    return _fits[key]


def _check_args(q, k_cache, v_cache) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or \
            k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B, 1, H, hd) and k, v caches (B, L, KV, "
                         f"hd), got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    if (k_cache.shape[0], k_cache.shape[3]) != (B, hd) or min(q.shape) == 0 \
            or k_cache.shape[1] == 0 or H % KV:
        raise ValueError(f"the caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)} (H a multiple of KV)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q and the caches must have one dtype, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")


def _check_kernel(q, k_cache, v_cache, cache_index) -> None:
    """Raise unless the kernels take these tensors: a head dim of
    `HEAD_DIMS`, float32 or bfloat16, at most `MAX_GROUP` query heads a KV
    head, hd's stride 1 and the other strides and the pointers on 16
    bytes, and (on CUDA) a 0-d int64 position on the same card."""
    hd, H, KV = q.shape[3], q.shape[2], k_cache.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the decode_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"the decode_attention kernel serves at most "
                         f"{MAX_GROUP} query heads a KV head, got {H // KV}")
    elt = q.element_size()
    for name, t, dims in (("q", q, (0, 2)), ("k_cache", k_cache, (0, 1, 2)),
                          ("v_cache", v_cache, (0, 1, 2))):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                t.stride(i) * elt % 16 for i in dims):
            raise ValueError(f"the decode_attention kernel reads {name} "
                             f"through its strides: hd's stride 1, the "
                             f"others multiples of 16 bytes and the tensor "
                             f"on 16 bytes, got strides {t.stride()} of "
                             f"{t.dtype}")
    if q.device.type == "cuda" and not (
            isinstance(cache_index, torch.Tensor) and cache_index.dim() == 0
            and cache_index.dtype == torch.int64
            and cache_index.device == q.device):
        raise ValueError(f"the decode_attention kernel reads the position "
                         f"as a 0-d int64 tensor on {q.device}, got "
                         f"{cache_index!r}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index, *,
                     scale=None) -> torch.Tensor:
    """q (B, 1, H, hd) over the caches k_cache, v_cache (B, L, KV, hd) at
    position cache_index (a 0-d int64 tensor; query head h reads KV head h
    // (H / KV)), over the min(cache_index + 1, L) slots filled so far ->
    (B, 1, H, hd) in q's dtype, contiguous on the card. Scores are scaled by
    `scale`, 1/sqrt(hd) when None. On the card the scores, probabilities
    and sums stay in fp32 and only the output is rounded; the plain version
    rounds scores and probabilities to the inputs' dtype, as the reference
    does."""
    _check_args(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_index,
                                        scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on CUDA or the CPU, got "
                         f"{q.device}")
    _check_kernel(q, k_cache, v_cache, cache_index)
    B, _, H, hd = q.shape
    L, KV = k_cache.shape[1:3]
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        cost.record("decode_attention", cost.decode_attention_work(
            B, H, KV, L, hd, q.element_size()))
        return out
    G = H // KV
    W = warps(fits(q.device, hd, G, q.dtype), B * KV * -(-G // ROWS), L)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    with torch.cuda.device(q.device):
        err = _lib().decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_index.data_ptr(), out.data_ptr(), B, H, KV, L, hd, strides,
            W,
            1.0 / math.sqrt(hd) if scale is None else float(scale),
            _build.DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "decode_attention")
    launches["decode_attention"] += 1
    return out
