"""RMSNorm on Hopper: the wrapper and its launch count.

The CUDA kernel in ``csrc/rmsnorm.cu`` replaces the Pallas TPU kernel
``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel``; that file's header says
what bounds it and how it is laid out. The wrapper takes the plain version
(`repro_torch.kernels.ref.rmsnorm_ref`) only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises; there is no backward kernel
yet, so a backward through a CUDA call raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

#: kernel launches; the wrapper adds one where it launches its kernel and
#: nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"rmsnorm": 0}


def reset_launches() -> None:
    launches["rmsnorm"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_fwd.argtypes = [P, P, P, I, I, ctypes.c_float, I, P]
        lib.rmsnorm_fwd.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (N, d), scale (d,) of one dtype (float32 or bfloat16) -> (N, d) in
    that dtype: x * rsqrt(mean(x^2) + eps) * scale per row, in fp32."""
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (N, d) tensor, got "
                         f"{tuple(x.shape)}")
    if scale.shape != (x.shape[1],):
        raise ValueError(f"scale must be ({x.shape[1]},), got "
                         f"{tuple(scale.shape)}")
    if x.dtype != scale.dtype or x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"x and scale must both be float32 or bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA or the CPU, got {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the rmsnorm kernel needs contiguous tensors")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"N and d must fit in int32, got {tuple(x.shape)}")
    return _build.forward_only("rmsnorm", _launch, x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    N, d = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), N, d, float(eps),
            _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rmsnorm")
    launches["rmsnorm"] += 1
    return y
