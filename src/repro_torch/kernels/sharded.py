"""Mesh-sharded wrappers for the port's kernels (row / batch data-parallel).

Counterpart of ``repro.kernels.sharded``. Each wrapper takes an input that
every rank holds whole, runs the `ops.py` kernel (the CUDA kernel on the
card, its plain version on the CPU) on this rank's contiguous slice of the
leading axis (logit rows for kd_loss and rmsnorm, the batch for
flash_attention) and gathers the slices over the mesh axis's group, so that
every rank returns the whole result. The three ops are row-independent, so
the result equals the unsharded kernel's bit for bit. Forward only: the
gather carries no gradient.
"""
from __future__ import annotations

from repro_torch.kernels.ops import (flash_attention_op, kd_loss_op,
                                     rmsnorm_op)
from repro_torch.launch.mesh import all_gather_rows, axis_sizes
from repro_torch.obs.trace import phase


def _check_divisible(n: int, mesh, axis: str, what: str) -> None:
    shards = axis_sizes(mesh)[axis]
    if n % shards:
        raise ValueError(f"{what}={n} not divisible by mesh {axis!r} "
                         f"axis size {shards}")


def _my_rows(n: int, mesh, axis: str) -> slice:
    per = n // axis_sizes(mesh)[axis]
    r = mesh.get_local_rank(axis)
    return slice(r * per, (r + 1) * per)


def sharded_kd_loss(x_logits, y_logits, labels, mesh, axis: str = "data"):
    """(N, V) x 2 + (N,) labels -> per-row {ce_x, ce_y, kl_xy, kl_yx}, rows
    split over the mesh's `axis`. N must divide by the axis size."""
    _check_divisible(x_logits.shape[0], mesh, axis, "rows")
    rows = _my_rows(x_logits.shape[0], mesh, axis)
    with phase(f"sharded.kd_loss@{axis_sizes(mesh)[axis]}"):
        out = kd_loss_op(x_logits[rows], y_logits[rows], labels[rows])
        return {k: all_gather_rows(v, mesh, axis) for k, v in out.items()}


def sharded_rmsnorm(x, scale, mesh, axis: str = "data", *, eps: float = 1e-5):
    """(N, D) row-sharded rmsnorm; the (D,) scale is every rank's."""
    _check_divisible(x.shape[0], mesh, axis, "rows")
    rows = _my_rows(x.shape[0], mesh, axis)
    with phase(f"sharded.rmsnorm@{axis_sizes(mesh)[axis]}"):
        return all_gather_rows(rmsnorm_op(x[rows], scale, eps=eps), mesh,
                               axis)


def sharded_flash_attention(q, k, v, mesh, axis: str = "data", *,
                            causal: bool = True, sliding_window: int = 0):
    """(B, H, S, hd) attention with the batch axis split over the mesh."""
    _check_divisible(q.shape[0], mesh, axis, "batch")
    rows = _my_rows(q.shape[0], mesh, axis)
    with phase(f"sharded.flash_attention@{axis_sizes(mesh)[axis]}"):
        out = flash_attention_op(q[rows], k[rows], v[rows], causal=causal,
                                 sliding_window=sliding_window)
        return all_gather_rows(out, mesh, axis)
