"""Mesh-sharded cohort engine: client-data-parallel batched training over
`torch.distributed` ranks.

Counterpart of ``repro.fl.sharded``. `BatchedClientEngine` (fl/batched.py)
trains a whole size group with one batched step per step, on one device.
This engine splits that group's padded client axis over the "data" axis of
a mesh (`launch/mesh.py`): rank r trains clients [r Cp / w, (r + 1) Cp / w)
on its own device through the same `make_batched_trainer` body, so each of
its steps runs one `kd_loss_grad` launch on its (Cp / w, B, V) logits.
Every client's mutual-KD steps are independent of every other client's, so
training needs no collective; one all_gather over the data group per
trained leaf gives every rank the whole (Cp, ...) stack.

Every rank runs the whole server (selection, the PPO agents, the data
streams, aggregation) from the same seed, so the server state stays
replicated, as in the reference's single program: each rank draws every
client's data (the loaders' streams advance alike) and keeps only its
rows. Cross-size cohorts never share a dispatch; each size group is its
own mesh-wide step loop, one after the other.

The client axis is padded to pow2 (the batched engine's discipline) and up
to a multiple of the data-axis size, so that every rank holds the same
number of (possibly fully-masked) clients: `pad_to_mesh`.
"""
from __future__ import annotations

from repro_torch.fl.batched import (BatchedClientEngine, make_batched_trainer,
                                    next_pow2, to_device)
from repro_torch.kernels.sharded import _check_divisible, _my_rows
from repro_torch.launch.mesh import (all_gather_rows, axis_sizes,
                                     make_debug_mesh)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def pad_to_mesh(n: int, n_shards: int) -> int:
    """Padded client-axis length: next_pow2 (min 4, the batched engine's
    discipline) rounded up to a multiple of the mesh data-axis size so every
    rank gets an equal client slice. For pow2 rank counts the rounding is a
    no-op once pow2(n) >= shards."""
    c = max(next_pow2(n), 4)
    return c if c % n_shards == 0 else ((c + n_shards - 1) // n_shards) * n_shards


def make_sharded_trainer(raw_step, init_opt, mesh, axis: str = "data",
                         device=None):
    """(start_params, xs, ys, mask) -> trained stacked params (Cp, ...) on
    every rank. xs (Cp, S, B, ...), ys (Cp, S, B) and mask (Cp, S) are host
    arrays that every rank holds whole; this rank trains its contiguous
    Cp / w rows on `device` with the batched engine's body, from `start`
    broadcast to its rows, and the trained rows are gathered over `axis`."""
    device = resolve_device(device)
    train = make_batched_trainer(raw_step, init_opt)

    def train_group(start, xs, ys, mask):
        _check_divisible(xs.shape[0], mesh, axis, "clients")
        rows = _my_rows(xs.shape[0], mesh, axis)
        per = rows.stop - rows.start
        stacked = tree_map(lambda p: p.expand((per,) + p.shape).contiguous(),
                           start)
        mine = train(stacked, *to_device(xs[rows], ys[rows], mask[rows],
                                         device))
        return tree_map(lambda t: all_gather_rows(t, mesh, axis), mine)

    return train_group


class ShardedClientEngine(BatchedClientEngine):
    """BatchedClientEngine with every size-group dispatch split over the
    ranks of a mesh axis. Drop-in: `train_cohort` has the same signature
    and returns per-client params in input order on every rank;
    `HAPFLServer(engine="sharded", mesh=...)` routes through it as it does
    through the batched and sequential engines. Without a mesh it spans
    the world (`make_debug_mesh`, which starts a one-rank group if none
    exists)."""

    def __init__(self, env, mesh=None, lr: float = None, axis: str = "data",
                 device=None):
        device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_debug_mesh(
            device=device)
        sizes = axis_sizes(self.mesh)
        if axis not in sizes:
            raise ValueError(f"mesh has no {axis!r} axis "
                             f"(axes: {tuple(sizes)})")
        self.axis = axis
        self.n_shards = sizes[axis]
        super().__init__(env, lr=lr, device=device)

    def _build_trainer(self, raw_step, init_opt):
        return make_sharded_trainer(raw_step, init_opt, self.mesh, self.axis,
                                    self.device)

    def _client_pad(self, n: int) -> int:
        return pad_to_mesh(n, self.n_shards)

    def _dispatch(self, size: str, start, xs, ys, mask):
        return self._trainers[size](start, xs, ys, mask)

    def _group_label(self, size: str, Cp: int, S: int) -> str:
        return (f"train_cohort[{size}]x{Cp}s{S}"
                f"@mesh{self.axis}={self.n_shards}")
