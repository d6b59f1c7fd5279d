"""Global model aggregation (paper §IV.E, Eqs. 36-39) on tensor trees.

Weights combine dataset information entropy and post-training accuracy:
    W = 1/2 (softmax(H) + softmax(acc))
LiteModels aggregate globally; heterogeneous local models aggregate per
size group (Eq. 5). Eq. 39's update is applied in delta form
``theta_global + sum_i W_i (theta_i - theta_global)`` which equals the
W-weighted average when sum W = 1 (it does, by construction). The weights
are numpy (copied from the reference); the sums run on the params' device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.utils.pytree import tree_map, tree_weighted_sum


def information_entropy(class_counts: Sequence[int]) -> float:
    """Eq. 36-37 over a client's label histogram."""
    counts = np.asarray(class_counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    q = counts[counts > 0] / total
    return float(-np.sum(q * np.log2(q)))


def _softmax(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    e = np.exp(v - v.max())
    return e / e.sum()


def aggregation_weights(entropies: Sequence[float],
                        accuracies: Sequence[float]) -> np.ndarray:
    """Eq. 38."""
    return 0.5 * (_softmax(np.asarray(entropies))
                  + _softmax(np.asarray(accuracies)))


def staleness_discount(staleness: Sequence[int],
                       exponent: float = 0.5) -> np.ndarray:
    """FedBuff-style polynomial staleness discount s(tau) = (1+tau)^-a.

    tau counts server aggregations between an update's dispatch version and
    its arrival; a fresh update (tau=0) is undiscounted.
    """
    return (1.0 + np.asarray(staleness, np.float64)) ** -float(exponent)


def staleness_weights(entropies: Sequence[float], accuracies: Sequence[float],
                      staleness: Optional[Sequence[int]] = None,
                      exponent: float = 0.5) -> np.ndarray:
    """Eq. 38 weights, staleness-discounted and renormalized. staleness=None
    applies no discount and returns Eq. 38 exactly."""
    w = aggregation_weights(entropies, accuracies)
    if staleness is None:
        return w
    w = w * staleness_discount(staleness, exponent)
    return w / w.sum()


def weighted_aggregate(global_params, client_params: List,
                       weights: Sequence[float], mix: float = 1.0):
    """Eq. 39 (delta form): theta + mix * sum W_i (theta_i - theta).

    mix=1 is the paper's full weighted average; mix<1 is the server mixing
    rate of the async apply-on-arrival policy."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    avg = tree_weighted_sum(client_params,
                            [float(x) for x in w.astype(np.float32)])
    mix = float(mix)
    return tree_map(lambda g, a: (g + mix * (a - g)).to(g.dtype),
                    global_params, avg)


def fedavg_aggregate(client_params: List, sizes: Sequence[int] = None):
    """Eq. 4 / FedAvg: (dataset-size weighted) parameter mean."""
    n = len(client_params)
    if sizes is None:
        w = [1.0 / n] * n
    else:
        tot = float(sum(sizes))
        w = [s / tot for s in sizes]
    return tree_weighted_sum(client_params, w)


def group_aggregate(global_by_size: Dict[str, object],
                    client_params: List, client_sizes: List[str],
                    entropies: Sequence[float], accuracies: Sequence[float],
                    staleness: Optional[Sequence[int]] = None,
                    staleness_exponent: float = 0.5, mix: float = 1.0,
                    ) -> Dict[str, object]:
    """Eq. 5 + Eq. 38-39: aggregate same-sized local models per group,
    optionally staleness-discounted."""
    out = dict(global_by_size)
    for size in set(client_sizes):
        idx = [i for i, s in enumerate(client_sizes) if s == size]
        w = staleness_weights(
            [entropies[i] for i in idx], [accuracies[i] for i in idx],
            None if staleness is None else [staleness[i] for i in idx],
            staleness_exponent)
        out[size] = weighted_aggregate(global_by_size[size],
                                       [client_params[i] for i in idx], w,
                                       mix=mix)
    return out
