"""Dry run: each (arch x input-shape) step of the port run once on the meta
device, its FLOPs, bytes, kernel calls and collectives counted, and set
against the H100's roofline. It never touches the card.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each step
for a TPU mesh and reads XLA's cost and memory analyses. The port runs its
own step functions on the meta tensors of `launch.specs` (shapes, no data):
`make_hapfl_train_step` for train (its backward and remat included),
`models.api.prefill` and `models.api.decode_step`. What it counts instead
of what XLA gave:

* FLOPs: every aten op dispatched, by `torch.utils.flop_counter`'s
  formulas (the matrix products; elementwise ops count none), plus each
  hand-written kernel's operations by its formula (`kernels.cost`): a
  kernel wrapper handed meta tensors returns outputs of the right shape,
  records its kernel's work and one call, and runs nothing.
* Bytes: the operand and result bytes of every aten op dispatched (the
  port runs eagerly, so each op reads and writes them), views and empty
  allocations excluded, plus each kernel's bytes by its formula.
* Collectives: the step is traced outside `launch.axes.use_axis_rules`,
  on no mesh, so it issues none (tracing under a mesh would issue the
  grouped MoE dispatch's and the length-sharded decode's collectives,
  which need a process group). The per-card collective bytes come from the
  sharding specs by formula (`collective_formula`, docs/port.md).
* Per card: the port does not partition compute as GSPMD does, so FLOPs
  and bytes a card are the whole step's divided by the card count (the
  ideal split); state bytes a card are exact, the sum of each input leaf's
  block under `launch.sharding`'s specs (the counterpart of XLA's
  ``argument_size_in_bytes``).

Full depth is cheap: `scan_corrected_cost` counts the step at 1 and 2
units of the layer stack (`_unit_layout`) at full width and extrapolates,
as the reference does; a microbatched train step is counted as one
microbatch (batch / microbatch, no accumulation) times the microbatch
count, which counts the optimizer update microbatch times (as the
reference notes, negligible).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import cost
from repro_torch.launch.hlo_analysis import count_op
from repro_torch.launch.mesh import (NODE_CARDS, axis_sizes,
                                     production_mesh_shape)
from repro_torch.launch.roofline_fixup import scan_flops
from repro_torch.launch.sharding import (MeshShape, batch_axes,
                                         batch_shardings, cache_shardings,
                                         entry_axes, opt_shardings,
                                         params_shardings, shard_shape,
                                         tree_bytes, zip_specs)
from repro_torch.launch.specs import input_specs
from repro_torch.models import api, ssm
from repro_torch.train.step import TrainStepConfig, make_hapfl_train_step

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

#: allocations that move no bytes
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}

#: the inner scans whose forward FLOPs are kept apart, and the functions of
#: `models.ssm` that run them (attention's are the flash kernel's)
MECHANISMS = {"ssd": "_ssd_chunk_scan", "mlstm": "_mlstm_chunk_scan",
              "slstm": "_slstm_scan"}


class _Counter(TorchDispatchMode):
    """FLOPs, bytes and op counts of every aten op dispatched inside it;
    the FLOPs of the ops inside a `MECHANISMS` function kept apart too."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Counter = Counter()
        self.scope: Optional[str] = None
        self.scoped: Dict[str, int] = {k: 0 for k in MECHANISMS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops[func.__name__] += 1
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            return out
        self.bytes += sum(t.numel() * t.element_size()
                          for t in tree_leaves((args, kwargs, out))
                          if isinstance(t, torch.Tensor))
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            self.flops += flops
            if self.scope is not None:
                self.scoped[self.scope] += flops
        return out


@contextlib.contextmanager
def _mechanism_scopes(counter: _Counter):
    """While open, the FLOPs of each MECHANISMS function (and what it calls)
    are also added to counter.scoped[mechanism]."""
    originals = {name: getattr(ssm, name) for name in MECHANISMS.values()}

    def scoped(mech, fn):
        def run(*args, **kwargs):
            prev, counter.scope = counter.scope, mech
            try:
                return fn(*args, **kwargs)
            finally:
                counter.scope = prev
        return run

    for mech, name in MECHANISMS.items():
        setattr(ssm, name, scoped(mech, originals[name]))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ssm, name, fn)


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def count_step(cfg: ModelConfig, shape: Union[str, ShapeConfig],
               cfg_lite: Optional[ModelConfig] = None,
               tcfg: TrainStepConfig = TrainStepConfig()) -> Dict:
    """Run one step of `cfg` at `shape` on meta tensors, once, counted:
    {"flops", "bytes" (aten ops and kernels together), "aten_flops",
    "aten_bytes", "kernels": {name: {"calls", "flops", "bytes"}},
    "mechanisms": {attention, ssd, mlstm, slstm: forward FLOPs},
    "ops": {aten op: count}}. Attention's FLOPs are the flash kernel's
    forward calls' (decode runs no flash kernel)."""
    shape = _shape(shape)
    cfg_lite = cfg_lite or cfg.lite()
    specs = input_specs(cfg, shape, cfg_lite, tcfg)
    counter = _Counter()
    with cost.counting() as tally, _mechanism_scopes(counter):
        if shape.mode == "train":
            step = make_hapfl_train_step(cfg, cfg_lite, tcfg)
            with counter:
                step(specs["state"], specs["batch"])
        else:
            with torch.no_grad(), counter:
                if shape.mode == "prefill":
                    api.prefill(specs["params"], cfg, specs["batch"])
                else:
                    api.decode_step(specs["params"], cfg, specs["batch"],
                                    specs["cache"], specs["cache_index"])
    kernels = {k: dict(v) for k, v in sorted(tally.items())}
    mech = dict(counter.scoped)
    mech["attention"] = kernels.get("flash_attention", {}).get("flops", 0)
    return {"flops": counter.flops + sum(v["flops"] for v in tally.values()),
            "bytes": counter.bytes + sum(v["bytes"] for v in tally.values()),
            "aten_flops": counter.flops, "aten_bytes": counter.bytes,
            "kernels": kernels, "mechanisms": mech, "ops": dict(counter.ops)}


def _unit_layout(cfg):
    """(unit_layers, n_units, tail_layers) for the depth extrapolation."""
    if cfg.block_kind == "xlstm" and cfg.slstm_every:
        u = cfg.slstm_every
    elif cfg.shared_attn_every:
        u = cfg.shared_attn_every
    else:
        u = 1
    return u, cfg.n_layers // u, cfg.n_layers % u


def _combine(r1, r2, scale, mb):
    """r1 + scale * (r2 - r1), times mb, over the nested numbers of two
    count_step records (ops by name included)."""
    if isinstance(r1, dict):
        return {k: _combine(r1.get(k, 0), r2.get(k, 0), scale, mb)
                for k in set(r1) | set(r2)}
    return (r1 + scale * max(r2 - r1, 0)) * mb


def scan_corrected_cost(cfg: ModelConfig, shape: Union[str, ShapeConfig],
                        tcfg: TrainStepConfig = TrainStepConfig(),
                        cfg_lite: Optional[ModelConfig] = None) -> Dict:
    """The full-depth count from two shallow ones: count the step at 1 and
    2 units of the layer stack, full width; delta = one unit; extrapolate
    to the full depth. Exact for tail-free stacks; the zamba2 tail (3
    Mamba2 layers of a 6-layer unit) is taken as tail / unit of a unit.
    A microbatched train step is counted as one microbatch, times the
    microbatch count. Every number of `count_step`'s record is
    extrapolated so (kernel calls too), and {"flops_per_unit", ...}
    added."""
    shape = _shape(shape)
    cfg_lite = cfg_lite or cfg.lite()
    mb = max(tcfg.microbatch, 1) if shape.mode == "train" else 1
    if mb > 1:
        shape = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // mb)
        tcfg = dataclasses.replace(tcfg, microbatch=0)
    u, n_units, tail = _unit_layout(cfg)

    def probe(k):
        return count_step(dataclasses.replace(
            cfg, name=f"{cfg.name}-probe{k}", n_layers=u * k), shape,
            cfg_lite, tcfg)

    r1, r2 = probe(1), probe(2)
    scale = (n_units - 1) + tail / u
    out = _combine(r1, r2, scale, mb)
    for k in ("flops", "bytes"):
        out[f"{k}_per_unit"] = max(r2[k] - r1[k], 0) * mb
    return out


# --------------------------------------------------------------------- #
# per card
# --------------------------------------------------------------------- #
def input_shardings(specs, shape: ShapeConfig, mesh):
    """The specs' sharding tree, in the reference's layout."""
    B = shape.global_batch
    if shape.mode == "train":
        p_sh = params_shardings(specs["state"]["params"], mesh)
        return {"state": {"params": p_sh,
                          "opt": opt_shardings(specs["state"]["opt"], p_sh,
                                               mesh)},
                "batch": batch_shardings(specs["batch"], mesh, B)}
    out = {"params": params_shardings(specs["params"], mesh),
           "batch": batch_shardings(specs["batch"], mesh, B)}
    if shape.mode == "decode":
        out["cache"] = cache_shardings(specs["cache"], mesh, B)
        out["cache_index"] = ()
    return out


def collective_formula(specs, shardings, shape: ShapeConfig, mesh) -> Dict:
    """Collective bytes a card, in the reference's {kind: {count, bytes}}
    shape: every parameter split over more than one card is gathered once
    (the whole leaf); in training its gradient is also reduce-scattered
    (the whole leaf), and a gradient left whole on a batch axis is
    all-reduced over those axes (its block). Activation collectives are
    not counted (docs/port.md)."""
    sizes = axis_sizes(mesh)
    stats = {k: {"count": 0, "bytes": 0}
             for k in ("all-gather", "reduce-scatter", "all-reduce")}
    train = shape.mode == "train"
    params = specs["state"]["params"] if train else specs["params"]
    p_sh = shardings["state"]["params"] if train else shardings["params"]
    data_axes = batch_axes(mesh, shape.global_batch)
    for leaf, spec in zip_specs(params, p_sh):
        whole = leaf.numel() * leaf.element_size()
        held = {a for e in spec for a in entry_axes(e)}
        if math.prod(sizes[a] for a in held) > 1:
            for kind in (("all-gather", "reduce-scatter") if train
                         else ("all-gather",)):
                stats[kind]["count"] += 1
                stats[kind]["bytes"] += whole
        free = [a for a in data_axes if a not in held and sizes[a] > 1]
        if train and free:
            block = shard_shape(leaf.shape, spec, mesh)
            stats["all-reduce"]["count"] += 1
            stats["all-reduce"]["bytes"] += (math.prod(block)
                                             * leaf.element_size())
    return {k: v for k, v in stats.items() if v["count"]}


def analyze(counted: Dict, meta: Dict, mesh, specs, shape: ShapeConfig
            ) -> Dict:
    """The reference's artifact fields from a count and the specs: per-card
    FLOPs, bytes and collective bytes, the roofline terms against
    `kernels.cost.HW`, the dominant term, the model's FLOPs and the useful
    share."""
    n_chips = math.prod(axis_sizes(mesh).values())
    shardings = input_shardings(specs, shape, mesh)
    coll = collective_formula(specs, shardings, shape, mesh)
    coll_bytes = sum(v["bytes"] for v in coll.values())
    flops = counted["flops"] / n_chips
    byts = counted["bytes"] / n_chips
    terms = {"compute_s": flops / cost.HW["peak_flops_bf16"],
             "memory_s": byts / cost.HW["hbm_bw"],
             "collective_s": coll_bytes / cost.HW["nvlink_bw"]}
    n_active = meta["params_local_active"]
    mult = 2
    if meta["mode"] == "train":
        n_active += meta["params_lite"]
        mult = 6
    model_flops = mult * n_active * meta["tokens"]
    return {
        **meta,
        "n_chips": n_chips,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": byts,
        "collective_bytes_per_chip": coll_bytes,
        "flops_total": counted["flops"],
        "bytes_total": counted["bytes"],
        "flops_per_unit": counted.get("flops_per_unit"),
        "kernels": counted["kernels"],
        "mechanisms": counted["mechanisms"],
        "collectives": coll,
        "memory": {"argument_size_in_bytes": tree_bytes(specs, shardings,
                                                        mesh),
                   "argument_size_total": tree_bytes(specs)},
        **terms,
        "dominant": max(terms, key=terms.get),
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / counted["flops"]
                               if counted["flops"] else None),
        "n_matmuls": sum(count_op(counted["ops"], op)
                         for op in ("mm", "bmm", "addmm", "baddbmm")),
    }


def step_meta(cfg: ModelConfig, cfg_lite: ModelConfig, shape: ShapeConfig,
              tcfg: TrainStepConfig, arch: str = None,
              variant: str = "faithful") -> Dict:
    return {"arch": arch or cfg.name, "shape": shape.name,
            "variant": variant, "params_local": cfg.num_params(),
            "params_local_active": cfg.active_params(),
            "params_lite": cfg_lite.num_params(), "mode": shape.mode,
            "tokens": shape.global_batch * (shape.seq_len
                                            if shape.mode != "decode" else 1),
            "microbatch": tcfg.microbatch, "loss_chunk": tcfg.loss_chunk}


def dry_run(cfg: ModelConfig, shape: Union[str, ShapeConfig], mesh, *,
            cfg_lite: Optional[ModelConfig] = None,
            tcfg: TrainStepConfig = TrainStepConfig(), probes: bool = True,
            meta: Optional[Dict] = None) -> Dict:
    """`analyze` of `cfg`'s step at `shape` on `mesh` (a MeshShape or
    DeviceMesh): counted by `scan_corrected_cost` with probes, else the
    whole depth traced at once (exact, and a microbatched step run as it
    is)."""
    shape = _shape(shape)
    cfg_lite = cfg_lite or cfg.lite()
    t0 = time.perf_counter()
    counted = (scan_corrected_cost(cfg, shape, tcfg, cfg_lite) if probes
               else count_step(cfg, shape, cfg_lite, tcfg))
    t_count = time.perf_counter() - t0
    specs = input_specs(cfg, shape, cfg_lite, tcfg)
    meta = meta or step_meta(cfg, cfg_lite, shape, tcfg)
    out = analyze(counted, meta, mesh, specs, shape)
    out["count_s"] = round(t_count, 2)
    out["probes"] = probes
    B = shape.global_batch
    S = shape.seq_len if shape.mode != "decode" else 1
    out["scan_formula_flops"] = scan_flops(cfg, B, S)
    return out


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """The production layout's shape, without devices: one NVLink node of
    8 cards on "model", (1, 8); (2, 1, 8) with multi_pod."""
    sizes, names = production_mesh_shape(NODE_CARDS * (2 if multi_pod
                                                       else 1), multi_pod)
    return MeshShape(tuple(sizes), tuple(names))


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            tcfg: TrainStepConfig = TrainStepConfig()) -> Dict:
    """The dry run of `arch` at `shape_name` on the production mesh, its
    summary printed. A full-attention arch runs long_500k as its
    sliding-window variant, as the reference's default does."""
    mesh = production_mesh(multi_pod)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    variant = "faithful"
    if shape_name == "long_500k" and not cfg.subquadratic:
        cfg = cfg.long_ctx_variant()
        variant = "swa"
    cfg_lite = cfg.lite()
    meta = step_meta(cfg, cfg_lite, shape, tcfg, arch, variant)
    meta["mesh"] = "x".join(map(str, mesh.sizes)) + \
        ("(pod,data,model)" if multi_pod else "(data,model)")
    result = dry_run(cfg, shape, mesh, cfg_lite=cfg_lite, tcfg=tcfg,
                     meta=meta)
    mem = result["memory"]
    print(f"[{arch} x {shape_name} x {meta['mesh']}] variant={variant} "
          f"count={result['count_s']:.1f}s")
    print(f"  state bytes/card: {mem['argument_size_in_bytes']:.4e} of "
          f"{mem['argument_size_total']:.4e}")
    print(f"  counted: flops/card={result['hlo_flops_per_chip']:.4e} "
          f"bytes/card={result['hlo_bytes_per_chip']:.4e}")
    print(f"  kernels: " + ", ".join(
        f"{k} {v['calls']:g}" for k, v in result["kernels"].items()))
    print(f"  collectives: {result['collectives']}")
    print(f"  roofline: compute={result['compute_s']:.4f}s "
          f"memory={result['memory_s']:.4f}s "
          f"collective={result['collective_s']:.4f}s "
          f"dominant={result['dominant']}")
    return result


def artifact_path(arch, shape_name, multi_pod, tag=""):
    mesh_tag = "multipod" if multi_pod else "singlepod"
    safe = arch.replace("/", "_").replace(".", "_")
    suffix = f"-{tag}" if tag else ""
    return ARTIFACT_DIR / f"{safe}--{shape_name}--{mesh_tag}{suffix}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached")
    ap.add_argument("--tag", default="", help="artifact suffix (perf exps)")
    ap.add_argument("--microbatch", type=int, default=4,
                    help="grad-accum microbatches for train_4k (0 = off)")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="sequence-chunked KD loss (memory-term lever)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    tcfg = TrainStepConfig(microbatch=args.microbatch,
                           loss_chunk=args.loss_chunk)
    t0 = time.perf_counter()
    failures = []
    for arch in archs:
        for shape_name in shapes:
            path = artifact_path(arch, shape_name, args.multi_pod, args.tag)
            if path.exists() and not args.force:
                print(f"cached: {path.name}")
                continue
            try:
                res = run_one(arch, shape_name, multi_pod=args.multi_pod,
                              tcfg=tcfg)
                path.write_text(json.dumps(res, indent=1, default=str))
            except Exception as e:  # noqa: BLE001 - listed below
                traceback.print_exc()
                failures.append((arch, shape_name, str(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall dry-runs OK ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
