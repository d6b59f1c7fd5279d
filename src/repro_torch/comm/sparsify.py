"""Per-tensor magnitude top-k sparsification.

A tensor is sent as (indices, values) of its k largest-magnitude entries,
k = max(1, round(ratio * size)). Selection is deterministic: a *stable*
sort on negated magnitudes breaks ties by index, so the same tensor always
produces the same support regardless of platform argsort internals.

The dropped (1 - ratio) mass is what error feedback (repro_torch.comm.codec)
carries to the next round: coordinates that keep losing the top-k race
accumulate in the residual until their magnitude wins, so every
coordinate is eventually transmitted and the compression error stays
bounded instead of growing with the round count.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def topk_count(size: int, ratio: float) -> int:
    """k for a tensor of `size` entries: at least 1, at most all of them."""
    return max(1, min(int(round(ratio * size)), size))


def topk_select(x: np.ndarray, ratio: float) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, values) of the top-k |x| entries of the flattened tensor.

    Indices are int32, sorted ascending (wire-friendly for delta coding);
    values are the exact float32 entries at those positions.
    """
    flat = np.asarray(x, np.float32).ravel()
    k = topk_count(flat.size, ratio)
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    idx = np.sort(order).astype(np.int32)
    return idx, flat[idx]


def densify(idx: np.ndarray, vals: np.ndarray,
            shape: Tuple[int, ...]) -> np.ndarray:
    """Scatter (indices, values) back to a dense float32 tensor of `shape`."""
    out = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
    out[np.asarray(idx, np.int64)] = np.asarray(vals, np.float32)
    return out.reshape(shape)
