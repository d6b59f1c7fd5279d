"""Device meshes over `torch.distributed`, and the collectives the sharded
paths run over a mesh axis.

Counterpart of ``repro.launch.mesh``. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the current
process group, with the reference's axis names: ("data", "model"), and a
leading "pod" axis in the multi-pod layout. A rank is one process; which
card it runs on is its own choice (`init_world`).

**Backend rule.** NCCL when every rank has a card of its own; gloo when
ranks share a card or run on the CPU (`choose_backend`). The rule is applied
once, when the group starts, and logged; a backend that fails is never
replaced by another. NCCL refuses two ranks on one device, so ranks that
share one card run gloo, whose collectives on CUDA tensors are staged
through the host here (`all_gather_rows`, `all_reduce_`).

Functions, not module constants: importing this module starts no process
group and touches no device.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# HW, the card's datasheet figures, lives with the kernels' cost formulas
from repro_torch.kernels.cost import HW  # noqa: F401
from repro_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# the production layout's "model" axis: the 8 cards of one NVLink node
NODE_CARDS = 8


def backend_for(device_type: str, world_size: int, n_cards: int) -> str:
    """The backend rule: "nccl" when the ranks run on CUDA and each has a
    card of its own (world_size <= n_cards), else "gloo"."""
    return ("nccl" if device_type == "cuda" and world_size <= n_cards
            else "gloo")


def choose_backend(device, world_size: int) -> str:
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    return backend_for(device.type, world_size, n_cards)


def init_world(rank: int, world_size: int, init_method: str,
               device=None) -> Tuple[str, torch.device]:
    """Join a process group of `world_size` ranks at `init_method` (e.g.
    ``tcp://localhost:<port>``) as `rank`, with the backend of the rule for
    `device` (CUDA when None). Returns (backend, this rank's device): its
    own card under NCCL, made current; the one card `device` names when
    ranks share it under gloo; or the CPU."""
    mine = resolve_device(device)
    backend = choose_backend(mine, world_size)
    if mine.type == "cuda":
        mine = torch.device("cuda", rank if backend == "nccl"
                            else mine.index or 0)
        torch.cuda.set_device(mine)
    logger.info("rank %d of %d: backend %s on %s", rank, world_size,
                backend, mine)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend, mine


def _start_single_rank(device) -> None:
    """A one-rank group on an in-memory store, so that a mesh exists in one
    process without a launcher (as the reference's mesh over one device)."""
    device = resolve_device(device)
    backend = choose_backend(device, 1)
    logger.info("one-rank group: backend %s on %s", backend, device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh(shape: Sequence[int], names: Tuple[str, ...]) -> DeviceMesh:
    # the mesh's device type names where its groups' collectives run: NCCL
    # on the cards, gloo on the host
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).view(*shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=names)


def make_debug_mesh(n_devices: Optional[int] = None, model: int = 1, *,
                    device=None) -> DeviceMesh:
    """A (n // model, model) ("data", "model") mesh over the n ranks of the
    current group (the whole world when n_devices is None). Without a group,
    a one-rank group starts first, with the backend of the rule for
    `device` (CUDA when None)."""
    if not dist.is_initialized():
        _start_single_rank(device)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world or n % model:
        raise ValueError(f"a debug mesh spans the whole world of {world} "
                         f"ranks in whole rows of model={model}; asked for "
                         f"{n}")
    return _mesh((n // model, model), ("data", "model"))


def production_mesh_shape(world_size: int, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production layout over `world_size` cards: ("data", "model") with
    one NVLink node of 8 cards on "model", and a leading "pod" axis of 2
    with `multi_pod` (the reference's (16, 16) and (2, 16, 16) TPU pods)."""
    pods = 2 if multi_pod else 1
    per = pods * NODE_CARDS
    if world_size < per or world_size % per:
        raise ValueError(f"{world_size} cards do not fill {pods} pod(s) of "
                         f"whole {NODE_CARDS}-card nodes")
    data = world_size // per
    if multi_pod:
        return (2, data, NODE_CARDS), ("pod", "data", "model")
    return (data, NODE_CARDS), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over the current (NCCL) world."""
    shape, names = production_mesh_shape(dist.get_world_size(), multi_pod)
    return _mesh(shape, names)


# --------------------------------------------------------------------- #
# axes and collectives
# --------------------------------------------------------------------- #
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object with the
    reference mesh's `axis_names` and `shape` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


#: the records of the open `launch.hlo_analysis.collective_stats()` blocks,
#: {kind: {"count", "bytes"}} each: every collective below adds its output
#: bytes to all of them
_STATS: List[Dict[str, Dict[str, int]]] = []


def _record(kind: str, nbytes: int) -> None:
    for stats in _STATS:
        row = stats.setdefault(kind, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += nbytes


def _staged(x: torch.Tensor, group) -> bool:
    """gloo's collectives are run on host copies of CUDA tensors."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str) -> torch.Tensor:
    """Concatenate every rank's `x` along dim 0, in the order of the ranks'
    coordinates on `axis`. The bytes move as they are (a uint8 view), so
    the result is bitwise the ranks' tensors in every dtype. It carries no
    gradient."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    raw = src.view(-1).view(torch.uint8)
    staged = _staged(raw, group)
    if staged:
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat(parts)
    _record("all-gather", out.numel())
    if staged:
        out = out.to(x.device)
    return out.view(x.dtype).view((n * x.shape[0],) + tuple(x.shape[1:]))


def all_reduce_(x: torch.Tensor, op, mesh: DeviceMesh,
                axis: str) -> torch.Tensor:
    """In-place all_reduce of `x` with `op` (a `dist.ReduceOp`) over the
    ranks of `axis`; returns x."""
    group = mesh.get_group(axis)
    _record("all-reduce", x.numel() * x.element_size())
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=op, group=group)
    return x
