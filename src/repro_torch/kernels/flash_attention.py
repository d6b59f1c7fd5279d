"""Flash attention on Hopper: the wrappers, the autograd Function and their
launch counts.

The CUDA kernels in ``csrc/flash_attention.cu`` (bf16: wgmma and TMA; fp32:
SIMT) replace the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` and add grouped KV
heads; ``csrc/flash_attention_bwd.cu`` adds the backward it lacks. The
files' headers say what bounds them and how they are laid out. They read
their inputs through their strides, so the transposed views of the model's
(B, S, H, hd) tensors go in without a copy, and every output (o, and dq,
dk, dv) is a (B, H, S, hd) view of a (B, S, H, hd) tensor. A wrapper takes
the plain version (`repro_torch.kernels.ref`) only for tensors on the CPU.
For CUDA tensors it launches its kernels or raises. For meta tensors (the
dry run) it returns empty outputs of the kernels' shapes and records their
work (`kernels.cost`), launching nothing: the plain version's S x S scores
are not the work the card does. Where autograd records,
the forward runs under `FlashAttention`, which also keeps the rows'
log-sum-exp, and its backward is the backward kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build, cost, ref

#: kernel launches; the wrapper adds one where it launches its kernel and
#: nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

#: head dims the kernels are instantiated for; 112 (zamba2-7b's shared
#: block) runs on 128's tiles, its last 16 columns zero-filled by TMA (bf16)
#: or by the loads (fp32) and never stored
HEAD_DIMS = (64, 112, 128)

#: head dims of the bf16 forward alone (no backward, no fp32 kernel): 224
#: (Zamba2-7B's shared blocks) runs on 256-wide tiles, its last 32 columns
#: zero-filled by TMA and never stored
FWD_HEAD_DIMS = (224,)

#: rows of the bf16 backward's tiles; its D and lse scratch rows are padded
#: to a multiple of it
TILE_ROWS = 64


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            P, P, P, P, P, I, I, I, I, I, ctypes.POINTER(ctypes.c_longlong),
            I, I, ctypes.c_float, I, P]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = [
            P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
            ctypes.POINTER(ctypes.c_longlong), I, I, ctypes.c_float, I, P]
        lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _bshd_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, N, S, hd) view of a (B, S, N, hd) tensor shaped
    and typed as t."""
    B, N, S, hd = t.shape
    return torch.empty((B, S, N, hd), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            sliding_window: int, with_lse: bool = False, scale=None):
    """o, or (o, lse) with lse (B, H, S) fp32 when with_lse; scores scaled
    by `scale`, 1/sqrt(hd) when None."""
    B, H, S, hd = q.shape
    o = _bshd_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        cost.record("flash_attention", cost.flash_work(
            B, H, k.shape[1], S, hd, sliding_window, q.element_size(),
            causal))
        return (o, lse) if with_lse else o
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                         for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H,
            k.shape[1], S, hd, strides, int(causal), int(sliding_window),
            1.0 / math.sqrt(hd) if scale is None else float(scale),
            _build.DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention")
    launches["flash_attention"] += 1
    return (o, lse) if with_lse else o


def bwd_scratch_shape(B: int, H: int, S: int, dtype: torch.dtype):
    """The fp32 scratch of the backward: D = rowsum(dO o) per query row,
    (B H, S) for float32; for bfloat16 D and the rows' lse in log2 units,
    each (B H, S rounded up to TILE_ROWS), which the wgmma kernels copy a
    whole tile's rows at a time."""
    if dtype == torch.float32:
        return (B * H, S)
    return (2, B * H, -(-S // TILE_ROWS) * TILE_ROWS)


def _launch_bwd(q, k, v, o, lse, do, causal: bool, sliding_window: int):
    B, H, S, hd = q.shape
    dq, dk, dv = _bshd_like(q), _bshd_like(k), _bshd_like(v)
    if q.device.type == "meta":
        cost.record("flash_attention_bwd", cost.flash_bwd_work(
            B, H, k.shape[1], S, hd, sliding_window, q.element_size(),
            causal))
        return dq, dk, dv
    delta = torch.empty(bwd_scratch_shape(B, H, S, q.dtype),
                        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib_bwd().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, k.shape[1], S, hd, strides,
            int(causal), int(sliding_window), 1.0 / math.sqrt(hd),
            _build.DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernels read t by its strides: hd's stride 1, the others
    multiples of 16 bytes, the row stride below 2^31, 16-byte aligned."""
    return not (t.stride(3) != 1 or t.data_ptr() % 16
                or t.stride(2) >= 2 ** 31
                or any(st * t.element_size() % 16 for st in t.stride()[:3]))


def _check_views(tensors, what: str) -> None:
    for t in tensors:
        if not _readable(t):
            raise ValueError(
                f"the {what} kernel needs hd's stride 1, the other strides "
                f"multiples of 16 bytes (the row stride below 2^31) and "
                f"16-byte aligned tensors, got strides {t.stride()} of "
                f"{t.dtype}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, sliding_window: int = 0):
    """The backward of `flash_attention` from its output o and row
    log-sum-exp lse (B, H, S) fp32: the upstream gradient do of o ->
    (dq, dk, dv) in q's dtype, shaped as q, k and v
    (`ref.flash_attention_bwd_ref`). On CUDA each is the (B, N, S, hd) view
    of a (B, S, N, hd) tensor; a do the kernel cannot read by its strides
    is made contiguous first."""
    _check_args(q, k, v, sliding_window)
    B, H, S, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse "
                         f"{(B, H, S)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("o and do must have q's dtype and lse float32")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal,
                                           sliding_window=sliding_window)
    _check_cuda(q, k, v, S, hd, forward=False)
    if not _readable(do):
        do = do.contiguous()
    _check_views((o, do), "flash_attention_bwd")
    return _launch_bwd(q, k, v, o, lse.contiguous(), do, causal,
                       sliding_window)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` on CUDA under autograd: the forward kernel, which
    also writes the rows' log-sum-exp, and the backward kernels from the
    saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        o, lse = _launch(q, k, v, causal, sliding_window, with_lse=True)
        ctx.causal, ctx.window = causal, sliding_window
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         sliding_window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    scale=None) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, KV, S, hd) with H % KV == 0, one dtype
    (float32 or bfloat16) -> (B, H, S, hd) in that dtype. Query head h
    reads KV head h // (H / KV); scores are scaled by `scale`, 1/sqrt(hd)
    when None. Any S; hd 64, 112 or 128 on CUDA, and 224 in bfloat16 with
    no gradient (`FWD_HEAD_DIMS`), where q, k and v may be strided views
    (hd's stride 1, the others multiples of 16 bytes) and the result is the
    (B, H, S, hd) view of a (B, S, H, hd) tensor, so that
    ``.transpose(1, 2)`` gives it back contiguous."""
    _check_args(q, k, v, sliding_window)
    B, H, S, hd = q.shape
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=sliding_window,
                                       scale=scale)
    _check_cuda(q, k, v, S, hd)
    _check_views((q, k, v), "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if scale is not None or hd in FWD_HEAD_DIMS:
            raise ValueError(f"flash_attention's backward takes hd in "
                             f"{HEAD_DIMS} and the 1/sqrt(hd) scale, got hd "
                             f"{hd}, scale {scale}")
        return FlashAttention.apply(q, k, v, causal, sliding_window)
    return _launch(q, k, v, causal, sliding_window, scale=scale)


def _check_args(q, k, v, sliding_window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, S, hd) and k, v (B, KV, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd) or min(q.shape) == 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV != 0:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0, got {sliding_window}")


def _check_cuda(q, k, v, S: int, hd: int, forward: bool = True) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, got "
                         f"{q.device}")
    wide = forward and q.dtype == torch.bfloat16
    if hd not in HEAD_DIMS + (FWD_HEAD_DIMS if wide else ()):
        raise ValueError(f"the flash_attention{'' if forward else '_bwd'} "
                         f"kernel takes hd in {HEAD_DIMS}"
                         + (f", and {FWD_HEAD_DIMS} in the bfloat16 forward"
                            if forward else "") + f", got {hd}")
    if (S + 63) // 64 > 65535:
        raise ValueError(f"S must be at most {65535 * 64} (the grid's second "
                         f"dimension), got {S}")
