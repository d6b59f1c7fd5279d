"""The benchmark of the PyTorch and CUDA port, `repro_torch`, on NVIDIA
cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout and prints, as
the last line of its standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device` and, last, `checks` (each number
compared to decide `correct`, beside its limit; the same lines end its
standard error). It exits non-zero, and prints no result, without a CUDA
card (there is no CPU fallback), with fewer cards than the cell asks for,
outside a checkout (no `src/repro_torch`), or when JAX or the JAX package
`repro` was loaded in this process.

What it runs and how it is measured:

- set-up (`setup_s`, from the process's start to the first timed step)
  makes the weights from the seed on the card, loads the kernels from
  `build/repro_torch/` (built there by the program on a checkout's first
  run) and the imported modules' bytecode from `build/portbench/pycache/`
  (written on the first run), and warms the cell's own shapes through the
  timed entry itself;
- the window runs the cell's job for --seconds, closed loop;
- with --trace 1, a few steps or calls timed by the host around the
  program's layers (each synchronised), then a few under torch.profiler;
  the per-layer metrics are read from those records by `metrics/<name>.py`;
- then the program's state is freed and the plain reference
  (`reference/`, float32, TF32 off, no code of the program) judges what the
  timed path produced.

How to add to it, with new files only (a file that is here is never
edited):

- a configuration: `configs/<name>.json` with the source's keys as run,
  the published values of those changed under "published" (their names
  are BENCHMARK.json's "reduced"), and its "lite" model; an entry under
  "configs" in BENCHMARK.json;
- a cell: `workloads/<name>.json` naming its configuration, its job
  ("train" or "serve", or a new `jobs/<job>.py` with `make(ctx)`), its
  traffic parameters (read by `traffic.py`), its limits and its traced
  slice; an entry under "workloads" in BENCHMARK.json, and the cell's name
  in the "workloads" list of each metric it reports;
- a per-layer metric: `metrics/<name>.py` with `read(rec)`, returning the
  number or None where the run recorded nothing it can read; an entry
  under "per_layer" in BENCHMARK.json.

`benchmarks/` and `artifacts/bench/` belong to the JAX package `repro`;
nothing here reads them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc), else since this
    module was imported."""
    try:
        tick = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / tick
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.time() - T_IMPORT


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(ctx, e2e: list, per_layer: list) -> dict:
    """Set-up, window or traced slice, judgement: the result object."""
    from portbench import harness
    torch = ctx.torch
    job = harness.load_module("jobs", ctx.cell["job"]).make(ctx)
    ctx.marks = (list(getattr(ctx, "marks", []))
                 + [("start of set-up", ctx.since_start())])
    job.setup()
    setup_s = ctx.since_start()
    if ctx.trace:
        sl = ctx.cell["trace"]
        w = job.traced(sl["span"], sl["profile"])
    else:
        w = job.window(ctx.seconds)
    on_card = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    job.free()
    checks = harness.Checks()
    t_judge = time.perf_counter()
    judged = job.judge(checks)
    print("portbench: set-up marks " + ", ".join(
        f"{k} {v:.3f} s" for k, v in ctx.marks), file=sys.stderr)
    if "latencies" in w:
        print("portbench: window " + " ".join(
            f"{v:.4f}" for v in w["latencies"]), file=sys.stderr)
        a = w["alloc"]
        print("portbench: allocator retries,mallocs a step " + " ".join(
            f"{r1 - r0},{m1 - m0}" for (r0, m0), (r1, m1) in zip(a, a[1:])),
            file=sys.stderr)
    print(f"portbench: set-up {setup_s:.3f} s, judgement "
          f"{time.perf_counter() - t_judge:.3f} s, "
          f"peak {peak / 2**30:.2f} GiB", file=sys.stderr)
    metrics = {}
    if ctx.trace:
        rec = dict(w["record"], judged=judged)
        for m in per_layer:
            v = harness.load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = job.e2e(w, setup_s)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if on_card
                       else "cpu"),
              "count": ctx.cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": checks.correct(), "attempted": job.attempted(w),
           "failed": int(w["failed"]), "metrics": metrics, "device": device}
    if ctx.trace:
        prof = w["record"]["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["wall_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, _, s in prof["kernels"][:10]],
            "idle_gaps": prof["gaps"][:10]}
    out["checks"] = checks.as_dict()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    man = harness.manifest(ROOT)
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    cache = ROOT / "build" / "portbench"
    # the bytecode of every module the run imports (torch's among them) is
    # kept in the checkout too, so that only the first run compiles it
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    import torch
    marks = [("torch imported", process_age())]
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.cuda.init()
    marks.append(("CUDA ready", process_age()))
    ctx = SimpleNamespace(torch=torch, device=torch.device("cuda", 0),
                          seed=args.seed, seconds=args.seconds,
                          trace=args.trace, cell=cell, config=config,
                          since_start=process_age, marks=marks)
    e2e, per_layer = harness.cell_metrics(man, args.workload)
    out = execute(ctx, e2e, per_layer)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
