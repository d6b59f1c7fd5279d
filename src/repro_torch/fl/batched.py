"""Batched multi-client training engine: a client axis written out over the
params, a Python loop over steps.

The engine groups the round's cohort by (model-size category, loader batch
size, pow2 step bucket) — clients in a group share an architecture, so their
parameter trees stack into (clients, ...) tensors. Each client's full step
sequence is prefetched in one vectorized rng draw
(`data.pipeline.prefetch_steps`), zero-padded to a power-of-two step count
S, and the client axis is padded to a power of two (minimum 4) with dummy
clients that see all-zero data. One step of a group is then one batched
forward of both models (`models.cnn.apply_cnn_fast`, GEMMs batched over
clients), one kd_loss kernel call on the (C*B, V) logit rows, one backward
pass and one SGD update; a masked step (padding) leaves the params and the
optimizer state (momentum and step count) untouched.

Because `sample_many` reproduces `sample()`'s rng stream element-for-element
and masked steps never touch parameters, the engine matches the reference's
batched and sequential engines to float tolerance.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.distill import make_mutual_train_fns
from repro_torch.models.cnn import apply_cnn_fast
from repro_torch.obs.trace import current as _tracer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def masked_select(new, old, keep: torch.Tensor):
    """Tree-wise torch.where(keep, new, old) with keep (C,) over the leading
    client axis — drops a masked step's update. A 0-d leaf (the optimizer's
    step count) comes back per client, (C,)."""
    def sel(a, b):
        k = keep.view(keep.shape + (1,) * (max(a.dim(), 1) - 1))
        return torch.where(k, a, b)
    return tree_map(sel, new, old)


def make_batched_trainer(raw_step, init_opt):
    """(stacked_params, xs, ys, mask, *extra) -> trained stacked_params.

    raw_step/init_opt come from make_mutual_train_fns (or, with the global
    params as `extra`, make_single_train_fns). Shapes: xs (C, S, B, ...),
    ys (C, S, B), mask (C, S) bool; params leaves carry a leading client
    axis C; `extra` goes to every step as it is."""
    def train(params, xs, ys, mask, *extra):
        opt_state = init_opt(params)
        for t in range(xs.shape[1]):
            p2, o2, _ = raw_step(params, opt_state, xs[:, t], ys[:, t],
                                 *extra)
            params = masked_select(p2, params, mask[:, t])
            opt_state = masked_select(o2, opt_state, mask[:, t])
        return params
    return train


class BatchedClientEngine:
    """Trains a whole HAPFL cohort with one batched step per size group and
    step, on `device` (CUDA when None)."""

    def __init__(self, env, lr: float = None, device=None):
        self.env = env
        self.device = resolve_device(device)
        lr = env.cfg.lr if lr is None else lr
        self._trainers = {}
        for s, c in env.pool.items():
            raw, init_opt = make_mutual_train_fns(
                lambda p, x, c=c: apply_cnn_fast(p, c, x),
                lambda p, x: apply_cnn_fast(p, env.lite_cfg, x), lr=lr)
            self._trainers[s] = make_batched_trainer(raw, init_opt)

    @staticmethod
    def _client_pad(n: int) -> int:
        """Padded client-axis length for an n-client group."""
        return max(next_pow2(n), 4)

    def train_cohort(self, clients: Sequence[int], sizes: Sequence[str],
                     intensities: Sequence[int], global_by_size: Dict,
                     lite_params, pad_pow2: bool = True,
                     pad_clients: bool = True) -> List[Dict]:
        """Run every client's {local, lite} mutual-KD training; returns
        per-client params dicts aligned with the input order, each leaf a
        view of its group's stacked tensor on the device.

        Ragged intensities are bucketed: within a (size, batch) group,
        clients whose step counts share a pow2 ceiling train together
        (masked-step waste < 2x). pad_pow2=False / pad_clients=False train
        the exact step and client counts (the sequential engine, and the
        pad-invariance checks)."""
        env = self.env
        bpe = env.cfg.batches_per_epoch
        out: List = [None] * len(clients)
        groups: Dict = {}
        for i, (c, s) in enumerate(zip(clients, sizes)):
            sb = next_pow2(int(intensities[i]) * bpe) if pad_pow2 else 0
            groups.setdefault((s, env.loaders[c].batch_size, sb), []).append(i)
        for (s, _, _), idx in groups.items():
            steps = [int(intensities[i]) * bpe for i in idx]
            S = next_pow2(max(steps)) if pad_pow2 else max(steps)
            xs, ys, mask = env.prefetch_round([clients[i] for i in idx],
                                              steps, pad_to=S)
            C = len(idx)
            Cp = self._client_pad(C) if pad_clients else C
            if Cp > C:
                pad = Cp - C
                xs = np.concatenate(
                    [xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
                ys = np.concatenate(
                    [ys, np.zeros((pad,) + ys.shape[1:], ys.dtype)])
                mask = np.concatenate(
                    [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)])
            start = {"local": global_by_size[s], "lite": lite_params}
            stacked = tree_map(
                lambda p: p.expand((Cp,) + p.shape).contiguous(), start)
            # names the group's step loop both in our tracer (wall span)
            # and in any active torch.profiler trace
            with _tracer().annotation(f"train_cohort[{s}]x{Cp}s{S}"):
                trained = self._trainers[s](
                    stacked, torch.from_numpy(xs).to(self.device),
                    # int32, the kernel's label type: no cast per step
                    torch.from_numpy(ys.astype(np.int32, copy=False)).to(
                        self.device),
                    torch.from_numpy(mask).to(self.device))
            for j, i in enumerate(idx):
                out[i] = tree_map(lambda a, j=j: a[j], trained)
        return out
