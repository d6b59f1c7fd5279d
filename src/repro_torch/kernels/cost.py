"""The work of each kernel, by formula: the bytes it must move and the
operations it does, the least time the card could take for them, and the
dry run's tally of the kernels it meets on the meta device.

One source for two readers. ``chip_smoke.py`` divides these formulas by the
card's rates (`HW`, below) for each kernel's bound; the
dry run (`repro_torch.launch.dryrun`) adds them to a step's count. A kernel
wrapper handed meta tensors (which hold shapes and no data) returns outputs
of the right shape and dtype, launches nothing and runs no plain version:
it calls `record` with its kernel's work and adds nothing to its launch
count. Inside `counting()` those records are summed.

Bytes are each input read once and each output written once. Operations
are the kernel's arithmetic: for flash attention the two (forward) or five
(backward) matrix products over the (query, key) pairs its mask leaves
visible, 2 a multiply-add, and for the decode attention the same over the
slots it reads; for the norms and kd_loss the fp32 operations an element
(exps not counted).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM5 80 GB, datasheet figures (dense, no sparsity) at the card's
# 700 W power limit: what the kernels' bounds here and the dry run's roofline
# (`launch.dryrun`) divide by; `launch.mesh` re-exports it. A card set below
# 700 W runs slower under load.
HW = {
    "card": "NVIDIA H100 SXM5 80GB, 700 W (datasheet)",
    "peak_flops_bf16": 989e12,   # FLOP/s
    "peak_flops_fp32": 67e12,    # FLOP/s, outside the tensor cores
    "hbm_bw": 3.35e12,           # B/s
    "nvlink_bw": 900e9,          # B/s a card, all links together
    "hbm_bytes": 80e9,
}

#: the dry run's tally, {kernel: {"calls", "flops", "bytes"}}, while
#: `counting()` is open
_TALLY: Optional[Dict[str, Dict[str, float]]] = None


@contextlib.contextmanager
def counting():
    """Sum the kernels' work met on the meta device inside the block into
    the yielded dict {kernel: {"calls", "flops", "bytes"}}."""
    global _TALLY
    prev, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def record(name: str, work: Tuple[float, float]) -> None:
    """One call of kernel `name` that does work = (bytes, operations)."""
    if _TALLY is None:
        return
    row = _TALLY.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    row["calls"] += 1
    row["bytes"] += work[0]
    row["flops"] += work[1]


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible, for one head of S
    positions: query i sees keys [max(0, i - window + 1), i] (causal) or
    [max(0, i - window + 1), S) (not), the whole range without a window."""
    w = window if window and window < S else 0
    if causal:
        return S * (S + 1) // 2 if not w else w * (w + 1) // 2 + (S - w) * w
    if not w:
        return S * S
    # query i loses the i - w + 1 keys before its window
    return S * S - (S - w) * (S - w + 1) // 2


# ---------------------------------------------------------------------- #
# (bytes, operations) of one launch
# ---------------------------------------------------------------------- #
def kd_fwd_work(N: int, V: int, elt: int) -> Tuple[int, int]:
    """kd_loss_fwd: x, y (N*V each) and labels read, 8 fp32 rows of N
    written; 2 exps and about 10 fp32 operations per (x, y) element
    pair."""
    return 2 * N * V * elt + 4 * N + 32 * N, 12 * N * V


def kd_bwd_work(N: int, V: int, elt: int) -> Tuple[int, int]:
    """kd_loss_bwd: x, y, labels, 4 stats and 4 upstream rows read, dx, dy
    written; 2 exps and about 14 operations per pair."""
    return 4 * N * V * elt + 4 * N + 32 * N, 16 * N * V


def grad_work(C: int, B: int, V: int, elt: int) -> Tuple[int, int]:
    """kd_loss_grad: x, y read and dx, dy written once, labels read and the
    (6, C) means written; about 28 fp32 operations and 4 exps per (x, y)
    element pair (the forward's and the backward's, less what they
    share)."""
    N = C * B
    return 4 * N * V * elt + 4 * N + 24 * C, 28 * N * V


def norm_work(N: int, d: int, elt: int) -> Tuple[int, int]:
    """rmsnorm: x read and y written once, scale read once; about 4 fp32
    operations per element (square-add, two multiplies, the cast)."""
    return 2 * N * d * elt + d * elt, 4 * N * d


def add_norm_work(N: int, d: int, elt: int) -> Tuple[int, int]:
    """add_rmsnorm: x and delta read, s and y written once, scale read
    once; about 5 fp32 operations per element."""
    return 4 * N * d * elt + d * elt, 5 * N * d


def norm_bwd_work(N: int, d: int, elt: int, add: bool) -> Tuple[int, int]:
    """rmsnorm_bwd: x, dy read and dx written once (add_rmsnorm_bwd: s,
    g_s, g_y read and d_s written), scale read and dscale written once;
    about 10 fp32 operations per element."""
    return (4 if add else 3) * N * d * elt + 2 * d * elt, 10 * N * d


def flash_work(B: int, H: int, KV: int, S: int, hd: int, window: int,
               elt: int, causal: bool = True) -> Tuple[int, int]:
    """flash_attention: Q and O (B, H, S, hd) and K, V (B, KV, S, hd) moved
    once; QK^T and PV over the visible pairs, 2 operations per multiply-add
    (the softmax's exps are not counted)."""
    nbytes = (2 * B * H + 2 * B * KV) * S * hd * elt
    return nbytes, 4 * hd * B * H * visible_pairs(S, causal, window)


def flash_bwd_work(B: int, H: int, KV: int, S: int, hd: int, window: int,
                   elt: int, causal: bool = True) -> Tuple[int, int]:
    """flash_attention_bwd: q, o, dO, dq (B, H, S, hd) and k, v, dk, dv
    (B, KV, S, hd) moved once, lse read once; five products over the
    visible pairs (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K), 2
    operations per multiply-add."""
    nbytes = (4 * B * H + 4 * B * KV) * S * hd * elt + 4 * B * H * S
    return nbytes, 10 * hd * B * H * visible_pairs(S, causal, window)


def decode_attention_work(B: int, H: int, KV: int, slots: int, hd: int,
                          elt: int) -> Tuple[int, int]:
    """decode_attention: K and V (B, KV, slots, hd) read once over the
    slots it attends to, q read and o written (B, H, hd); q K^T and p V
    over those slots, 2 operations per multiply-add (the exps not
    counted). On meta tensors the position is unknown, so slots is the
    cache's L, the most a call reads."""
    return (2 * B * KV * slots * hd * elt + 2 * B * H * hd * elt,
            4 * B * H * slots * hd)


def sumsq_work(leaves) -> Tuple[int, int]:
    """The norm's sum of squares over leaves of (numel, gradient element
    size, param element size): each gradient read once; 2 operations an
    element."""
    return (sum(n * g for n, g, _ in leaves),
            2 * sum(n for n, _, _ in leaves))


def adamw_work(leaves) -> Tuple[int, int]:
    """The AdamW step in place over leaves of (numel, gradient element
    size, param element size): g read, p, m and v (fp32) read and written
    once, 22 bytes an element at bf16 g and p; about 16 fp32 operations an
    element (3 divisions and a square root among them)."""
    return (sum(n * (g + 2 * p + 16) for n, g, p in leaves),
            16 * sum(n for n, _, _ in leaves))


# ---------------------------------------------------------------------- #
# bounds: the least time (ms) on the card, and what sets it
# ---------------------------------------------------------------------- #
def _bound(nbytes, ops, ops_per_s):
    t_b = nbytes / HW["hbm_bw"] * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _rate(dtype: str) -> float:
    """The tensor cores' bf16 rate for bf16 inputs, else the fp32 rate."""
    return HW["peak_flops_bf16" if dtype == "bfloat16" else
              "peak_flops_fp32"]


def kd_bounds(N, V, elt):
    """{kd_loss_fwd, kd_loss_bwd: (bound_ms, bound_by)}: bytes over 3.35
    TB/s against fp32 operations over 67 TFLOP/s, the larger."""
    return {"kd_loss_fwd": _bound(*kd_fwd_work(N, V, elt),
                                  HW["peak_flops_fp32"]),
            "kd_loss_bwd": _bound(*kd_bwd_work(N, V, elt),
                                  HW["peak_flops_fp32"])}


def grad_bound(C, B, V, elt):
    return _bound(*grad_work(C, B, V, elt), HW["peak_flops_fp32"])


def norm_bound(N, d, elt):
    return _bound(*norm_work(N, d, elt), HW["peak_flops_fp32"])


def add_norm_bound(N, d, elt):
    return _bound(*add_norm_work(N, d, elt), HW["peak_flops_fp32"])


def norm_bwd_bound(N, d, elt, add):
    return _bound(*norm_bwd_work(N, d, elt, add), HW["peak_flops_fp32"])


def flash_bound(B, H, KV, S, hd, window, dtype, elt):
    return _bound(*flash_work(B, H, KV, S, hd, window, elt), _rate(dtype))


def flash_bwd_bound(B, H, KV, S, hd, window, dtype, elt):
    return _bound(*flash_bwd_work(B, H, KV, S, hd, window, elt),
                  _rate(dtype))


def decode_attention_bound(B, H, KV, slots, hd, elt):
    """Operations at the fp32 rate (bf16's products run on the tensor
    cores, faster still): bytes set the bound at every config's shape."""
    return _bound(*decode_attention_work(B, H, KV, slots, hd, elt),
                  HW["peak_flops_fp32"])


def sumsq_bound(leaves):
    return _bound(*sumsq_work(leaves), HW["peak_flops_fp32"])


def adamw_bound(leaves):
    return _bound(*adamw_work(leaves), HW["peak_flops_fp32"])
