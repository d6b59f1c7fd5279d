"""kd_loss on Hopper: the wrappers, their launch counts and the
autograd.Function.

The CUDA kernels in ``csrc/kd_loss.cu`` replace the Pallas TPU kernel
``src/repro/kernels/kd_loss.py::_kd_kernel`` and add the backward it lacks;
that file's header says what bounds them and how they are laid out.
`kd_loss_grad` is the HAPFL step's: the loss's batch means and both logit
gradients of the mutual-KD loss in one launch. `kd_loss_fwd`,
`kd_loss_bwd` and `KDLoss` serve `core.distill.mutual_losses`, a loss that
autograd differentiates. A
wrapper takes the plain version (`repro_torch.kernels.ref`) only for tensors
on the CPU. For CUDA tensors it launches its kernel or raises: a build or
launch failure is never covered by the plain version. For meta tensors (the
dry run) it returns empty outputs of the kernel's shapes and records its
work (`kernels.cost`), launching nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build, cost, ref

#: kernel launches per wrapper; each wrapper adds one where it launches its
#: kernel and nowhere else (CPU calls go to the plain version, uncounted)
launches: Dict[str, int] = {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                            "kd_loss_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("kd_loss")
    if lib.kd_loss_fwd.argtypes is None:
        lib.kd_loss_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.kd_loss_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _P]
        F = ctypes.c_float
        lib.kd_loss_grad.argtypes = [_P, _P, _P, ctypes.c_longlong, _I, _I,
                                     _I, F, F, F, F, _P, _P, _P, _P, _P, _I,
                                     _P]
        for fn in (lib.kd_loss_fwd, lib.kd_loss_bwd, lib.kd_loss_grad):
            fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape != y.shape or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"logits must be two non-empty (N, V) tensors of one "
                         f"shape, got {tuple(x.shape)} and {tuple(y.shape)}")
    if labels.shape != (x.shape[0],):
        raise ValueError(f"labels must be ({x.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    if x.dtype != y.dtype or x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"logits must both be float32 or bfloat16, got "
                        f"{x.dtype} and {y.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if not (x.device == y.device == labels.device):
        raise ValueError("logits and labels must be on one device")


def _cuda_args(x, y, labels, *more):
    """Checks that only the kernel path needs; returns int32 labels."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"kd_loss kernels run on CUDA, got {x.device}")
    for t in (x, y, labels) + more:
        if not t.is_contiguous():
            raise ValueError("kd_loss kernels need contiguous tensors")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"N and V must fit in int32, got {tuple(x.shape)}")
    return labels if labels.dtype == torch.int32 else labels.to(torch.int32)


def kd_loss_fwd(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, V) logits x, y and (N,) labels -> terms (4, N) fp32 = (ce_x,
    ce_y, kl_xy, kl_yx) and stats (4, N) fp32 = (lse_x, lse_y, e_x, e_y)."""
    _check(x, y, labels)
    if x.device.type == "cpu":
        return ref.kd_loss_fwd_ref(x, y, labels)
    lab = _cuda_args(x, y, labels)
    N, V = x.shape
    out = torch.empty((8, N), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        cost.record("kd_loss_fwd", cost.kd_fwd_work(N, V, x.element_size()))
        return out[:4], out[4:]
    with torch.cuda.device(x.device):
        err = _lib().kd_loss_fwd(
            x.data_ptr(), y.data_ptr(), lab.data_ptr(), out.data_ptr(), N, V,
            _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "kd_loss_fwd")
    launches["kd_loss_fwd"] += 1
    return out[:4], out[4:]


def kd_loss_bwd(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor,
                stats: torch.Tensor, grads: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx, dy), in the logits' dtype, from the forward's stats
    and the upstream per-row gradients grads (4, N) of (ce_x, ce_y, kl_xy,
    kl_yx)."""
    _check(x, y, labels)
    N, V = x.shape
    for t, what in ((stats, "stats"), (grads, "grads")):
        if t.shape != (4, N) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{what} must be (4, {N}) float32 on {x.device}")
    if x.device.type == "cpu":
        return ref.kd_loss_bwd_ref(x, y, labels, stats, grads)
    lab = _cuda_args(x, y, labels, stats, grads)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    if x.device.type == "meta":
        cost.record("kd_loss_bwd", cost.kd_bwd_work(N, V, x.element_size()))
        return dx, dy
    with torch.cuda.device(x.device):
        err = _lib().kd_loss_bwd(
            x.data_ptr(), y.data_ptr(), lab.data_ptr(), stats.data_ptr(),
            grads.data_ptr(), dx.data_ptr(), dy.data_ptr(), N, V,
            _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "kd_loss_bwd")
    launches["kd_loss_bwd"] += 1
    return dx, dy


class KDLoss(torch.autograd.Function):
    """Per-row (ce_x, ce_y, kl_xy, kl_yx) of logits x (local model), y
    (LiteModel) and labels, differentiable in x and y through the backward
    kernel.

    The gradients carry the stop-gradients of the paper's Eqs. 33-34
    (``repro.core.distill.mutual_losses``): ce_x and kl_xy = KL(x || sg(y))
    send gradient to x only, ce_y and kl_yx = KL(y || sg(x)) to y only. So
    a loss l1*ce_x + l2*kl_xy + l3*ce_y + l4*kl_yx trains the local model by
    L1 and the LiteModel by L2 in one backward pass.
    """

    @staticmethod
    def forward(ctx, x, y, labels):
        terms, stats = kd_loss_fwd(x, y, labels)
        ctx.save_for_backward(x, y, labels, stats)
        return tuple(terms.unbind(0))

    @staticmethod
    def backward(ctx, g_ce_x, g_ce_y, g_kl_xy, g_kl_yx):
        x, y, labels, stats = ctx.saved_tensors
        grads = torch.stack([g_ce_x, g_ce_y, g_kl_xy, g_kl_yx]).float()
        dx, dy = kd_loss_bwd(x, y, labels, stats, grads)
        return dx, dy, None


def kd_loss(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """Differentiable per-row terms {ce_x, ce_y, kl_xy, kl_yx}, each (N,)
    fp32; see KDLoss for where the gradients go."""
    ce_x, ce_y, kl_xy, kl_yx = KDLoss.apply(x, y, labels)
    return {"ce_x": ce_x, "ce_y": ce_y, "kl_xy": kl_xy, "kl_yx": kl_yx}


#: per device, the zeroed per-client counters of kd_loss_grad's last-block
#: reduction; each launch leaves them zeroed again, so one launch at a time
#: may use them (the port runs on one stream)
_counters: Dict[torch.device, torch.Tensor] = {}


def _client_counters(device: torch.device, C: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < C:
        buf = _counters[device] = torch.zeros(
            max(C, 64), dtype=torch.int32, device=device)
    return buf


def kd_loss_grad(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor,
                 lambdas: Sequence[float]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mutual-KD step's loss terms and logit gradients in one launch.

    x (local model) and y (LiteModel) logits (C, B, V), labels (C, B); or
    (B, V) and (B,) for one client. lambdas (l1, l2, l3, l4) weigh ce_x,
    kl_xy, ce_y, kl_yx in each client's batch-mean loss. Returns dx, dy of
    the logits' shape and dtype (the gradients of the sum of the clients'
    losses, with the Eqs. 33-34 stop-gradients) and means (6, C) fp32: the
    batch means of ce_x, ce_y, kl_xy, kl_yx, acc_x and acc_y per client.
    Labels may be a strided (C, B) view with unit stride within a client.
    On CUDA a row pair must fit 16 blocks' shared memory (V up to 458,240
    in fp32, 916,480 in bf16); a wider row raises. Not differentiable: the
    result is the gradient."""
    if x.dim() == 2:
        dx, dy, means = kd_loss_grad(x[None], y[None], labels[None], lambdas)
        return dx[0], dy[0], means
    if x.dim() != 3 or x.shape != y.shape or 0 in x.shape:
        raise ValueError(f"logits must be two non-empty (C, B, V) or (B, V) "
                         f"tensors of one shape, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    C, B, V = x.shape
    if labels.shape != (C, B):
        raise ValueError(f"labels must be ({C}, {B}), got "
                         f"{tuple(labels.shape)}")
    if x.dtype != y.dtype or x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"logits must both be float32 or bfloat16, got "
                        f"{x.dtype} and {y.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if not (x.device == y.device == labels.device):
        raise ValueError("logits and labels must be on one device")
    if len(lambdas) != 4:
        raise ValueError(f"lambdas must be 4 weights, got {lambdas}")
    if x.device.type == "cpu":
        return ref.kd_loss_grad_ref(x, y, labels, lambdas)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"kd_loss kernels run on CUDA, got {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("kd_loss_grad needs contiguous logits")
    if labels.dtype != torch.int32 or labels.stride(1) != 1:
        labels = labels.to(torch.int32).contiguous()
    if C > 65535 or max(B, V, C * B) >= 2 ** 31:
        raise ValueError(f"C must be at most 65535 and C*B, V fit in int32, "
                         f"got {tuple(x.shape)}")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    rows = torch.empty((6, C * B), dtype=torch.float32, device=x.device)
    means = torch.empty((6, C), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        cost.record("kd_loss_grad", cost.grad_work(C, B, V, x.element_size()))
        return dx, dy, means
    with torch.cuda.device(x.device):
        err = _lib().kd_loss_grad(
            x.data_ptr(), y.data_ptr(), labels.data_ptr(), labels.stride(0),
            C, B, V, *(float(v) / B for v in lambdas), dx.data_ptr(),
            dy.data_ptr(), rows.data_ptr(),
            _client_counters(x.device, C).data_ptr(), means.data_ptr(),
            _build.DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "kd_loss_grad")
    launches["kd_loss_grad"] += 1
    return dx, dy, means
