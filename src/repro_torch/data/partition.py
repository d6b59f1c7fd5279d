"""Non-IID client partitioning (paper: Dirichlet, alpha = 0.4)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.4,
                        seed: int = 0, min_size: int = 8,
                        max_tries: int = 200) -> List[np.ndarray]:
    """Returns per-client index arrays with Dirichlet(alpha) class mixtures.

    min_size is clamped to what the dataset can actually provide, and the
    resample loop is bounded — tiny datasets with concentrated alpha made
    the old unconditional retry spin forever. If no draw satisfies the
    floor, the last draw is topped up by moving samples from the largest
    shards (deterministic, always terminates).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    min_size = min(min_size, len(labels) // n_clients)
    for _ in range(max_tries):
        idx_per_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    while min(len(ix) for ix in idx_per_client) < min_size:
        donor = max(range(n_clients), key=lambda i: len(idx_per_client[i]))
        needy = min(range(n_clients), key=lambda i: len(idx_per_client[i]))
        idx_per_client[needy].append(idx_per_client[donor].pop())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_per_client]


def label_histogram(labels: np.ndarray, indices: np.ndarray,
                    n_classes: int) -> np.ndarray:
    return np.bincount(labels[indices], minlength=n_classes)
