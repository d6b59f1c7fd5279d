"""Batching pipeline: shuffled epochs, iid sampling, and the prefetch path
used by the batched multi-client engine (``repro.fl.batched``).

``sample_many`` draws n batches in ONE vectorized rng call that produces the
exact same stream as n consecutive ``sample()`` calls (numpy's Generator
consumes the bit stream per element), so the sequential and batched training
engines see bit-identical data — the property the parity tests rely on.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class BatchLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 seed: int = 0):
        assert len(x) == len(y)
        self.x, self.y = x, y
        self.batch_size = min(batch_size, len(x))
        self.rng = np.random.default_rng(seed)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.x))
        nb = len(self.x) // self.batch_size
        for b in range(max(nb, 1)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) == 0:
                sel = order[: self.batch_size]
            yield self.x[sel], self.y[sel]

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        sel = self.rng.integers(0, len(self.x), size=self.batch_size)
        return self.x[sel], self.y[sel]

    def sample_many(self, n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """n_steps iid batches, stacked: x (n, B, ...), y (n, B)."""
        sel = self.rng.integers(0, len(self.x),
                                size=(n_steps, self.batch_size))
        return self.x[sel], self.y[sel]


def prefetch_client(loader: BatchLoader, n_steps: int, pad_to: int = None,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pre-sample exactly n_steps batches, zero-pad the step axis to pad_to.

    Returns x (S, B, ...), y (S, B), mask (S,) bool with S = pad_to or
    n_steps. Only the first n_steps entries are real; the padding is never
    applied by the masked train step, and — critically — the loader's rng
    advances by exactly n_steps draws, matching the sequential engine.
    """
    x, y = loader.sample_many(n_steps)
    S = pad_to or n_steps
    assert S >= n_steps
    if S > n_steps:
        x = np.concatenate(
            [x, np.zeros((S - n_steps,) + x.shape[1:], x.dtype)])
        y = np.concatenate(
            [y, np.zeros((S - n_steps,) + y.shape[1:], y.dtype)])
    mask = np.arange(S) < n_steps
    return x, y, mask


def prefetch_steps(loaders: Sequence[BatchLoader], clients: Sequence[int],
                   steps_per_client: Sequence[int], pad_to: int = None,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-client pre-sampled batches into dense (clients, steps, ...)
    arrays for the vmap-over-clients engine.

    Ragged step counts are handled by zero-padding to S = pad_to or
    max(steps) and returning a (clients, S) step mask. All listed clients
    must share one batch size (the engine groups by it).
    """
    S = pad_to or max(steps_per_client)
    bs = {loaders[c].batch_size for c in clients}
    assert len(bs) == 1, f"mixed batch sizes in one group: {bs}"
    xs, ys, ms = [], [], []
    for c, n in zip(clients, steps_per_client):
        x, y, m = prefetch_client(loaders[c], n, pad_to=S)
        xs.append(x)
        ys.append(y)
        ms.append(m)
    return np.stack(xs), np.stack(ys), np.stack(ms)
