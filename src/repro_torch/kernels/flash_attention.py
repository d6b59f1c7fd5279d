"""Flash attention on Hopper: the wrapper and its launch count.

The CUDA kernels in ``csrc/flash_attention.cu`` (bf16: wgmma and TMA; fp32:
SIMT) replace the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` and add grouped KV
heads; that file's header says what bounds them and how they are laid out.
They read q, k and v through their strides, so the transposed views of the
model's (B, S, H, hd) tensors go in without a copy, and the output is a
(B, H, S, hd) view of a (B, S, H, hd) tensor. The wrapper takes the plain
version (`repro_torch.kernels.ref.flash_attention_ref`) only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises; there is no
backward kernel yet, so a backward through a CUDA call raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

#: kernel launches; the wrapper adds one where it launches its kernel and
#: nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"flash_attention": 0}

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    launches["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            P, P, P, P, I, I, I, I, I, ctypes.POINTER(ctypes.c_longlong), I,
            I, ctypes.c_float, I, P]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            sliding_window: int) -> torch.Tensor:
    B, H, S, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                         for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            k.shape[1], S, hd, strides, int(causal), int(sliding_window),
            1.0 / math.sqrt(hd), _build.DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention")
    launches["flash_attention"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: int = 0) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, KV, S, hd) with H % KV == 0, one dtype
    (float32 or bfloat16) -> (B, H, S, hd) in that dtype. Query head h
    reads KV head h // (H / KV). Any S; hd 64 or 128 on CUDA, where q, k
    and v may be strided views (hd's stride 1, the others multiples of 16
    bytes) and the result is the (B, H, S, hd) view of a (B, S, H, hd)
    tensor, so that ``.transpose(1, 2)`` gives it back contiguous."""
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
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, got "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    for t in (q, k, v):
        if (t.stride(3) != 1 or t.data_ptr() % 16 or t.stride(2) >= 2 ** 31
                or any(st * t.element_size() % 16 for st in t.stride()[:3])):
            raise ValueError(
                f"the flash_attention kernel needs hd's stride 1, the other "
                f"strides multiples of 16 bytes (the row stride below 2^31) "
                f"and 16-byte aligned tensors, got strides {t.stride()} of "
                f"{t.dtype}")
    if (S + 63) // 64 > 65535:
        raise ValueError(f"S must be at most {65535 * 64} (the grid's second "
                         f"dimension), got {S}")
    return _build.forward_only("flash_attention", _launch, q, k, v, causal,
                               sliding_window)
