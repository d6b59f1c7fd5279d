"""RMSNorm on Hopper, alone and fused with the residual add before it: the
wrappers, their autograd Functions and their launch counts.

The CUDA kernels in ``csrc/rmsnorm.cu`` replace the Pallas TPU kernel
``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel`` and add the backward it
lacks; that file's header says what bounds them and how they are laid out.
A wrapper takes the plain version (`repro_torch.kernels.ref`) only for
tensors on the CPU. For CUDA tensors it launches its kernel or raises. For
meta tensors (the dry run, `repro_torch.launch.dryrun`) it returns empty
outputs of the kernel's shapes and records the kernel's work
(`kernels.cost`), launching nothing.
Where autograd records (grad mode on and an input that needs a gradient),
the CUDA launch runs under `RMSNorm` / `AddRMSNorm`, whose backward is the
backward kernel; elsewhere (serving, under no_grad) the launch runs alone.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, cost, ref

#: kernel launches per wrapper; each wrapper adds one where it launches its
#: kernel and nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"rmsnorm": 0, "add_rmsnorm": 0,
                            "rmsnorm_bwd": 0, "add_rmsnorm_bwd": 0}

#: the longest row the kernels hold in registers
MAX_D = 8192

#: threads of a backward block, filled with whole rows (four of 128 at
#: d = 3072 in bf16)
BWD_BLOCK = 512


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_fwd.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rmsnorm_fwd.argtypes = [P, P, P, I, I, F, I, P]
        lib.add_rmsnorm_fwd.argtypes = [P, P, P, P, P, I, I, F, I, P]
        lib.rmsnorm_bwd.argtypes = [P, P, P, P, P, P, P, P, I, I, F, I, I,
                                    P]
        lib.rmsnorm_fwd.restype = lib.add_rmsnorm_fwd.restype = ctypes.c_int
        lib.rmsnorm_bwd.restype = ctypes.c_int
    return lib


def _check(rows, scale: torch.Tensor, what: str) -> None:
    x = rows[0]
    for r in rows:
        if r.dim() != 2 or r.shape[0] == 0 or r.shape[1] == 0:
            raise ValueError(f"{what}: rows must be non-empty (N, d) tensors, "
                             f"got {tuple(r.shape)}")
        if r.shape != x.shape:
            raise ValueError(f"{what}: x and delta differ in shape, "
                             f"{tuple(x.shape)} and {tuple(r.shape)}")
    if scale.shape != (x.shape[1],):
        raise ValueError(f"{what}: scale must be ({x.shape[1]},), got "
                         f"{tuple(scale.shape)}")
    if any(t.dtype != x.dtype for t in (*rows, scale)) or (
            x.dtype not in _build.DTYPE_CODE):
        raise TypeError(f"{what}: every tensor must be float32, or every "
                        f"one bfloat16")
    if any(t.device != x.device for t in (*rows, scale)):
        raise ValueError(f"{what}: every tensor must be on one device")


def _check_cuda(rows, scale: torch.Tensor, what: str) -> None:
    x = rows[0]
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what} runs on CUDA or the CPU, got {x.device}")
    if not all(t.is_contiguous() for t in (*rows, scale)):
        raise ValueError(f"the {what} kernel needs contiguous tensors")
    if x.shape[0] >= 2 ** 31 or x.shape[1] > MAX_D:
        raise ValueError(f"{what}: N must fit in int32 and d be at most "
                         f"{MAX_D}, got {tuple(x.shape)}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (N, d), scale (d,) of one dtype (float32 or bfloat16) -> (N, d) in
    that dtype: x * rsqrt(mean(x^2) + eps) * scale per row, in fp32."""
    _check((x,), scale, "rmsnorm")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    _check_cuda((x,), scale, "rmsnorm")
    if _records(x, scale):
        return RMSNorm.apply(x, scale, eps)
    return _launch(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one launch: x, delta (N, d)
    and scale (d,) of one dtype -> (s, y), s = x + delta rounded to that
    dtype and y = rmsnorm(s, scale), both (N, d). On the card y equals
    `rmsnorm(x + delta, scale)` bit for bit."""
    _check((x, delta), scale, "add_rmsnorm")
    if x.device.type == "cpu":
        return ref.add_rmsnorm_ref(x, delta, scale, eps)
    _check_cuda((x, delta), scale, "add_rmsnorm")
    if _records(x, delta, scale):
        return AddRMSNorm.apply(x, delta, scale, eps)
    return _launch_add(x, delta, scale, eps)


def _records(*tensors) -> bool:
    """Whether autograd records a call on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `rmsnorm`: x, dy (N, d), scale (d,) of one dtype ->
    (dx, dscale) in that dtype (`ref.rmsnorm_bwd_ref`). dscale is summed in
    a fixed order: two calls give the same bits."""
    _check((x, dy), scale, "rmsnorm_bwd")
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps)
    _check_cuda((x, dy), scale, "rmsnorm_bwd")
    return _launch_bwd(x, scale, dy, None, eps, "rmsnorm_bwd")


def add_rmsnorm_bwd(s: torch.Tensor, scale: torch.Tensor,
                    g_s: Optional[torch.Tensor], g_y: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `add_rmsnorm` from its saved sum s (N, d): the
    upstream gradients g_s of s (None when s went unused) and g_y of y ->
    (d_s, dscale), d_s the gradient of both x and delta
    (`ref.add_rmsnorm_bwd_ref`)."""
    rows = (s, g_y) if g_s is None else (s, g_s, g_y)
    _check(rows, scale, "add_rmsnorm_bwd")
    if s.device.type == "cpu":
        return ref.add_rmsnorm_bwd_ref(s, scale, g_s, g_y, eps)
    _check_cuda(rows, scale, "add_rmsnorm_bwd")
    return _launch_bwd(s, scale, g_y, g_s, eps, "add_rmsnorm_bwd")


class RMSNorm(torch.autograd.Function):
    """`rmsnorm` on CUDA under autograd: the forward kernel, and the backward
    kernel from the saved input."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


class AddRMSNorm(torch.autograd.Function):
    """`add_rmsnorm` on CUDA under autograd: the forward kernel, and the
    backward kernel from the saved sum s; a gradient of s alone (y unused)
    passes straight to x and delta."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps):
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        s, y = _launch_add(x, delta, scale, eps)
        ctx.save_for_backward(s, scale)
        return s, y

    @staticmethod
    def backward(ctx, g_s, g_y):
        s, scale = ctx.saved_tensors
        if g_y is None:
            return g_s, g_s, None, None
        d_s, dscale = add_rmsnorm_bwd(
            s, scale, None if g_s is None else g_s.contiguous(),
            g_y.contiguous(), ctx.eps)
        return d_s, d_s, dscale, None


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    N, d = x.shape
    y = torch.empty_like(x)
    if x.device.type == "meta":
        cost.record("rmsnorm", cost.norm_work(N, d, x.element_size()))
        return y
    with torch.cuda.device(x.device):
        err = _lib().rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), N, d, float(eps),
            _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rmsnorm")
    launches["rmsnorm"] += 1
    return y


def _launch_add(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    N, d = x.shape
    s, y = torch.empty_like(x), torch.empty_like(x)
    if x.device.type == "meta":
        cost.record("add_rmsnorm", cost.add_norm_work(N, d, x.element_size()))
        return s, y
    with torch.cuda.device(x.device):
        err = _lib().add_rmsnorm_fwd(
            x.data_ptr(), delta.data_ptr(), scale.data_ptr(), s.data_ptr(),
            y.data_ptr(), N, d, float(eps), _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "add_rmsnorm")
    launches["add_rmsnorm"] += 1
    return s, y


def bwd_threads(d: int, elt: int) -> int:
    """Threads a row of the backward, for rows of d elements of elt bytes,
    as ``csrc/rmsnorm.cu``'s launch_bwd_packs picks them (as the forward
    does): 16-byte packs when d allows, at most 4 of them a thread (8
    single elements), 128 threads while that holds the row, a multiple of
    32."""
    vec = 16 // elt if d % (16 // elt) == 0 else 1
    n_pack = d // vec
    ppt = min(-(-n_pack // 128), 8 if vec == 1 else 4)
    return -(-(-(-n_pack // ppt)) // 32) * 32


def bwd_teams(d: int, elt: int) -> int:
    """Rows a block of the backward reduces at once: as many as fit in
    BWD_BLOCK threads, at least one."""
    return max(1, BWD_BLOCK // bwd_threads(d, elt))


def bwd_grid(N: int, d: int, elt: int, sm_count: int) -> int:
    """Blocks of the backward's persistent grid: one an SM, at most one row
    for each team. Fixed by N, d and the card, so that two calls sum dscale
    in one order (the kernel takes fewer if not all fit the card at
    once)."""
    return min(-(-N // bwd_teams(d, elt)), sm_count)


#: per device, the backward's grid-barrier words: an arrival count (word 0),
#: which each launch leaves at 0 (so one launch at a time may use it: the
#: port runs on one stream; a CUDA graph may replay it), and a generation
#: number (word 32, on another 128-byte line)
_counters: Dict[torch.device, torch.Tensor] = {}
#: (device, N, d, element size) -> bwd_grid on that device's SMs
_grids: Dict[Tuple[torch.device, int, int, int], int] = {}


def _bwd_counters(device: torch.device) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None:
        buf = _counters[device] = torch.zeros(64, dtype=torch.int32,
                                              device=device)
    return buf


def _launch_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                g_s: Optional[torch.Tensor], eps: float,
                name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    N, d = x.shape
    if x.device.type == "meta":
        cost.record(name, cost.norm_bwd_work(N, d, x.element_size(),
                                             g_s is not None))
        return torch.empty_like(x), torch.empty_like(scale)
    key = (x.device, N, d, x.element_size())
    if key not in _grids:
        _grids[key] = bwd_grid(N, d, x.element_size(),
                               torch.cuda.get_device_properties(
                                   x.device).multi_processor_count)
    # at most n_blocks: the kernel takes fewer if not all fit the card
    n_blocks = _grids[key]
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    scratch = torch.empty((n_blocks, d), dtype=torch.float32,
                          device=x.device)
    counters = _bwd_counters(x.device)
    with torch.cuda.device(x.device):
        err = _lib().rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
            None if g_s is None else g_s.data_ptr(), dx.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(), dscale.data_ptr(), N, d,
            float(eps), n_blocks, _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    launches[name] += 1
    return dx, dscale
