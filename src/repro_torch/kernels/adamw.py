"""The optimizer's passes on Hopper: the gradients' global norm and the
AdamW step in place, each one pass over every leaf of a tree.

The CUDA kernels in ``csrc/adamw.cu`` replace no Pallas kernel (the JAX
package's AdamW is plain jnp); that file's header says what bounds them
(bytes: 22 a parameter for the update at bf16 params and gradients, 2 for
the norm) and how each byte moves once. Their plain versions are
`repro_torch.optim.optimizers`' `global_norm_plain` and `adamw_plain_`
(per leaf, per slice of ``SLICE_ELEMENTS``), which `global_norm` and
`adamw(...).update_` take for leaves off CUDA; for CUDA leaves they call
the wrappers here, which launch or raise.

A launch takes at most `MAX_LEAVES` leaves as a kernel parameter, so a step
over the trained cells' 22-25 leaves is three launches: `sumsq`, then
`sumsq_finish` (the norm), then `adamw`. The update gives the plain
version's bits for the same clip factor; the norm sums in another order.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build

#: kernel launches per kernel; each wrapper adds one where it launches
launches: Dict[str, int] = {"sumsq": 0, "sumsq_finish": 0, "adamw": 0}

#: elements of a chunk (``csrc/adamw.cu``'s kChunk, which its launches check)
CHUNK = 1 << 16
#: leaves one launch takes (``csrc/adamw.cu``'s kMaxLeaves)
MAX_LEAVES = 64
#: bytes every leaf's start is a multiple of (the kernels' vector loads)
ALIGN = 16

_KERNEL = {"sumsq": 0, "adamw": 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class _Leaf(ctypes.Structure):
    """``csrc/adamw.cu``'s Leaf."""
    _fields_ = [("g", ctypes.c_void_p), ("p", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("first", ctypes.c_int),
                ("kinds", ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    if lib.adamw_step.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adamw_blocks_per_sm.argtypes = [I]
        lib.sumsq_partials.argtypes = [P, I, I, I, P, P]
        lib.sumsq_finish.argtypes = [P, I, P, P]
        lib.adamw_step.argtypes = [P, I, I, I, P, F, P, P, P, F, F, F, F, F,
                                   F, I, P]
        for fn in (lib.adamw_blocks_per_sm, lib.sumsq_partials,
                   lib.sumsq_finish, lib.adamw_step):
            fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------- #
# the chunk table, in Python so that the CPU tests reach it
# ---------------------------------------------------------------------- #
def chunk_starts(numels: Sequence[int]) -> Tuple[List[int], int]:
    """(each leaf's first chunk, the chunk count): leaf after leaf, each cut
    into chunks of `CHUNK` elements, the last one ragged; a leaf of no
    elements has none."""
    firsts, n = [], 0
    for numel in numels:
        firsts.append(n)
        n += -(-int(numel) // CHUNK)
    return firsts, n


def chunk_table(numels: Sequence[int]) -> List[Tuple[int, int, int]]:
    """The chunks as the kernels walk them: (leaf, offset, length) for each
    chunk number in order, as ``csrc/adamw.cu``'s chunk_leaf and chunk_span
    derive them from `chunk_starts`."""
    firsts, n_chunks = chunk_starts(numels)
    table, leaf = [], 0
    for chunk in range(n_chunks):
        while leaf + 1 < len(numels) and chunk >= firsts[leaf + 1]:
            leaf += 1
        off = (chunk - firsts[leaf]) * CHUNK
        table.append((leaf, off, min(CHUNK, int(numels[leaf]) - off)))
    return table


def groups(numels: Sequence[int]) -> List[List[int]]:
    """The leaves each launch takes, as indices: those with elements, at
    most `MAX_LEAVES` a launch, in order."""
    live = [i for i, n in enumerate(numels) if n]
    return [live[i:i + MAX_LEAVES] for i in range(0, len(live), MAX_LEAVES)]


def kinds(g_dtype: torch.dtype, p_dtype: Optional[torch.dtype]) -> int:
    """A leaf's kinds word: bit 0 g in bf16, bit 1 p in bf16."""
    return (int(g_dtype == torch.bfloat16)
            | 2 * int(p_dtype == torch.bfloat16))


def _table(grads, params=None, m=None, v=None):
    """A ctypes array of `_Leaf` for one launch's leaves, and its chunk
    count."""
    firsts, n_chunks = chunk_starts([g.numel() for g in grads])
    arr = (_Leaf * len(grads))()
    for i, g in enumerate(grads):
        p = params[i] if params is not None else None
        arr[i] = _Leaf(g.data_ptr(), p.data_ptr() if p is not None else None,
                       m[i].data_ptr() if m is not None else None,
                       v[i].data_ptr() if v is not None else None,
                       g.numel(), firsts[i],
                       kinds(g.dtype, p.dtype if p is not None else None))
    return arr, n_chunks


# ---------------------------------------------------------------------- #
# checks
# ---------------------------------------------------------------------- #
_DTYPES = (torch.float32, torch.bfloat16)


def check_leaves(grads: Sequence[torch.Tensor],
                 params: Optional[Sequence[torch.Tensor]] = None,
                 m: Optional[Sequence[torch.Tensor]] = None,
                 v: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Raise unless the kernels take these leaves: as many of each, every
    tensor contiguous, 16-byte aligned and on one device, g and p float32
    or bfloat16, m and v float32, each leaf's tensors of one shape."""
    lists = [("grads", grads)] + [(k, t) for k, t in
                                  (("params", params), ("m", m), ("v", v))
                                  if t is not None]
    if len({len(t) for _, t in lists}) != 1:
        raise ValueError("adamw kernels: grads, params, m and v must have "
                         "as many leaves each")
    if not grads:
        return
    device = grads[0].device
    for what, leaves in lists:
        for i, t in enumerate(leaves):
            if t.device != device:
                raise ValueError(f"adamw kernels: {what}[{i}] is on "
                                 f"{t.device}, grads[0] on {device}")
            if t.shape != grads[i].shape:
                raise ValueError(f"adamw kernels: {what}[{i}] is "
                                 f"{tuple(t.shape)}, its gradient "
                                 f"{tuple(grads[i].shape)}")
            want = (torch.float32,) if what in ("m", "v") else _DTYPES
            if t.dtype not in want:
                raise TypeError(f"adamw kernels: {what}[{i}] is {t.dtype}, "
                                f"not one of {want}")
            if not t.is_contiguous():
                raise ValueError(f"adamw kernels: {what}[{i}] is not "
                                 f"contiguous")
            if t.numel() and t.data_ptr() % ALIGN:
                raise ValueError(f"adamw kernels: {what}[{i}] does not start "
                                 f"on {ALIGN} bytes")


# ---------------------------------------------------------------------- #
# launches
# ---------------------------------------------------------------------- #
#: (device, kernel) -> blocks of a persistent grid: every SM's resident
#: blocks, from the occupancy API
_grids: Dict[Tuple[torch.device, str], int] = {}


def grid(device: torch.device, kernel: str, n_chunks: int) -> int:
    """Blocks of `kernel`'s launch over n_chunks chunks on `device`: all
    that the card holds at once, at most one a chunk. Fixed by the card and
    the leaves, so that the norm sums in one order."""
    key = (device, kernel)
    if key not in _grids:
        with torch.cuda.device(device):
            per_sm = _lib().adamw_blocks_per_sm(_KERNEL[kernel])
        if per_sm <= 0:
            raise RuntimeError(f"adamw kernels: no block of {kernel} fits an "
                               f"SM (CUDA error {-per_sm})")
        _grids[key] = per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
    return min(n_chunks, _grids[key])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads` (CUDA,
    float32 or bfloat16) as a 0-d float32 tensor on their card: one
    `sumsq` launch a group of `MAX_LEAVES` leaves, then `sumsq_finish`. No
    host sync; two calls give the same bits."""
    grads = list(grads)
    check_leaves(grads)
    device = grads[0].device
    if device.type != "cuda":
        raise ValueError(f"adamw kernels run on CUDA, got {device}")
    parts = groups([g.numel() for g in grads])
    plan = []
    for idx in parts:
        arr, n_chunks = _table([grads[i] for i in idx])
        plan.append((arr, n_chunks, grid(device, "sumsq", n_chunks)))
    partial = torch.empty(max(1, sum(b for _, _, b in plan)),
                          dtype=torch.float64, device=device)
    gn = torch.empty((), dtype=torch.float32, device=device)
    lib, at = _lib(), 0
    with torch.cuda.device(device):
        for arr, n_chunks, blocks in plan:
            err = lib.sumsq_partials(arr, len(arr), n_chunks, blocks,
                                     partial[at:].data_ptr(), _stream())
            _build.check_launch(err, "sumsq")
            launches["sumsq"] += 1
            at += blocks
        err = lib.sumsq_finish(partial.data_ptr(), at, gn.data_ptr(),
                               _stream())
    _build.check_launch(err, "sumsq_finish")
    launches["sumsq_finish"] += 1
    return gn


def _device_scalar(x, device, what: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != device:
        raise ValueError(f"adamw kernels: {what} must be a float32 scalar "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x


def adamw_(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
           m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
           lr: Union[float, torch.Tensor], bc1: torch.Tensor,
           bc2: torch.Tensor, scale: Optional[torch.Tensor], b1: float,
           b2: float, eps: float, weight_decay: float) -> None:
    """The AdamW step in place on CUDA leaves: params, m and v written, as
    `optimizers.adamw_plain_` writes them for the same step factors (lr a
    float or a 0-d float32 tensor; bc1, bc2 and the clip factor `scale`,
    None for none, 0-d float32 tensors on the leaves' card), bit for bit.
    One `adamw` launch a group of `MAX_LEAVES` leaves; no host sync."""
    grads, params, m, v = (list(t) for t in (grads, params, m, v))
    check_leaves(grads, params, m, v)
    if not grads:
        return
    device = grads[0].device
    if device.type != "cuda":
        raise ValueError(f"adamw kernels run on CUDA, got {device}")
    lr_t = (_device_scalar(lr, device, "lr").data_ptr()
            if isinstance(lr, torch.Tensor) else None)
    lr_value = 0.0 if isinstance(lr, torch.Tensor) else float(lr)
    ptrs = [_device_scalar(t, device, what).data_ptr()
            for t, what in ((bc1, "bc1"), (bc2, "bc2"))]
    scale_ptr = (None if scale is None else
                 _device_scalar(scale, device, "scale").data_ptr())
    lib = _lib()
    with torch.cuda.device(device):
        for idx in groups([g.numel() for g in grads]):
            arr, n_chunks = _table(*([t[i] for i in idx]
                                     for t in (grads, params, m, v)))
            err = lib.adamw_step(
                arr, len(arr), n_chunks, grid(device, "adamw", n_chunks),
                lr_t, lr_value, *ptrs, scale_ptr, b1, 1 - b1, b2, 1 - b2,
                eps, weight_decay, int(bool(weight_decay)), _stream())
            _build.check_launch(err, "adamw")
            launches["adamw"] += 1
