#!/usr/bin/env python3
"""A benchmark cell's job (`portbench/jobs/`) driven on one CUDA card with
the port's phase spans (`repro_torch.obs.trace.phase`) recording, to read
where its time goes and what the spans cost:

    python3 examples/phase_spans_torch.py --workload qwen3moe-serve-b32 \
        --seed 1 --out build/spans_serve.json

After the job's own set-up (weights from the seed, the warm-up steps or
calls):

- serve cells: a window of 16 calls with the tracer enabled from its
  first call, as the benchmark's window runs them; for each call its wall
  seconds, the host and device ms of `serve.generate`, the device ms of
  `serve.prefill`, of the replays (all, the shortest, the longest) and of
  the gaps between them, the caching allocator's device mallocs and
  retries, and the ms the garbage collector ran;
- every cell: the cost of the spans. Blocks of 8 steps or 3 calls
  alternate spans off and spans on, twice in each order: outside any
  profiler (on: an enabled tracer), and under the device-only
  torch.profiler the benchmark's traced run uses (off: the hot path's
  `phase` replaced by the null span). The mean wall ms of a step or call
  in each, and the spans of the enabled tracer's blocks: for each name,
  its count, device ms and host ms a step or call (no profiler running).

Prints the card's name and power limit, then one JSON line (also written
to --out).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
#: serve calls read one by one after set-up, as the benchmark's window
WINDOW_CALLS = 16


def card(torch) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def spans_off():
    """Replace `phase` in the modules of the hot path by the null span;
    returns the undo."""
    from repro_torch.models import moe
    from repro_torch.obs import trace
    from repro_torch.serve import engine
    from repro_torch.train import step
    mods = (step, moe, engine)
    saved = [m.phase for m in mods]
    for m in mods:
        m.phase = lambda name, **args: trace.NULL_TRACER.span(name)

    def undo():
        for m, p in zip(mods, saved):
            m.phase = p
    return undo


def by_root(recs: list) -> dict:
    """{name: {"count", "device_ms", "host_ms"}}: each name's spans summed
    within each root span and averaged over the roots."""
    roots = [r for r in recs if r["root"] == r["seq"]]
    out = {}
    for r in recs:
        row = out.setdefault(r["name"], {"count": 0, "device_ms": 0.0,
                                         "host_ms": 0.0})
        row["count"] += 1
        if r["device"] is not None:
            row["device_ms"] += r["device"][1] - r["device"][0]
        row["host_ms"] += 1e3 * (r["host"][1] - r["host"][0])
    return {k: {f: v / len(roots) for f, v in row.items()}
            for k, row in out.items()}


def cost(torch, one, block: int) -> dict:
    """Mean wall ms of `one()` (a step or call, closed loop) in blocks
    off, on, on, off, off, on, on, off; outside a profiler and under the
    device-only one."""
    from repro_torch.obs import trace
    out, tracers = {}, []
    for where in ("plain", "profiled"):
        ms = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off") * 2:
            undo = spans_off() if (mode == "off" and where == "profiled") \
                else None
            if mode == "on" and where == "plain":
                tracers.append(trace.enable(trace.Tracer()))
            prof = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
                if where == "profiled" else None)
            try:
                if prof is not None:
                    prof.__enter__()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(block):
                    one()
                torch.cuda.synchronize()
                ms[mode].append(1e3 * (time.perf_counter() - t0) / block)
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
                trace.disable()
                if undo is not None:
                    undo()
            trace.profiled(clear=True)
        out[where] = {k: sum(v) / len(v) for k, v in ms.items()}
        out[where]["blocks"] = ms
        out[where]["cost_pct"] = 100 * (out[where]["on"] / out[where]["off"]
                                        - 1)
    out["spans"] = by_root([trace.resolve(p) for t in tracers
                            for p in t.phases])
    return out


def serve_window(torch, job, calls: int) -> list:
    """`calls` window calls with the tracer enabled: one row each, with the
    milliseconds the garbage collector ran during the call."""
    import gc
    from repro_torch.obs import trace
    gc_ms, t_gc = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_ms[0] += 1e3 * (time.perf_counter() - t_gc[0])
    tracer = trace.enable(trace.Tracer())
    gc.callbacks.append(on_gc)
    c = max(job.calls) + 1
    lats, gcs = [], []
    try:
        for i in range(calls):
            gc_ms[0] = 0.0
            lats.append(job._call(c + i))
            gcs.append(gc_ms[0])
    finally:
        gc.callbacks.remove(on_gc)
        trace.disable()
    recs = [trace.resolve(p) for p in tracer.phases]
    rows = []
    roots = [r for r in recs if r["name"] == "serve.generate"]
    for lat, gc_call, root in zip(lats, gcs, roots):
        kids = [r for r in recs if r["root"] == root["seq"]
                and r["seq"] != root["seq"]]
        reps = sorted((r for r in kids if r["name"] == "serve.replay"),
                      key=lambda r: r["seq"])
        pre = next(r for r in kids if r["name"] == "serve.prefill")

        def dev(r):
            return r["device"][1] - r["device"][0]
        rows.append({
            "wall_s": lat,
            "generate_host_ms": 1e3 * (root["host"][1] - root["host"][0]),
            "generate_device_ms": dev(root),
            "prefill_device_ms": dev(pre),
            "prefill_host_ms": 1e3 * (pre["host"][1] - pre["host"][0]),
            "replays_device_ms": sum(dev(r) for r in reps),
            "replay_ms_min": min(dev(r) for r in reps),
            "replay_ms_max": max(dev(r) for r in reps),
            "gc_ms": gc_call,
            "gaps_device_ms": sum(b["device"][0] - a["device"][1]
                                  for a, b in zip(reps, reps[1:])),
            "before_first_replay_ms": reps[0]["device"][0] - pre["device"][1],
            "after_last_replay_ms": root["device"][1] - reps[-1]["device"][1],
            **root["args"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("phase_spans_torch: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    t_start = time.time()
    ctx = SimpleNamespace(torch=torch, device=torch.device("cuda", 0),
                          seed=args.seed, seconds=0.0, trace=0, cell=cell,
                          config=config,
                          since_start=lambda: time.time() - t_start,
                          marks=[])
    job = harness.load_module("jobs", cell["job"]).make(ctx)
    job.setup()
    print(card(torch), flush=True)
    out = {"workload": args.workload, "seed": args.seed, "card": card(torch)}
    if cell["job"] == "serve":
        out["window"] = serve_window(torch, job, WINDOW_CALLS)
        c = [max(job.calls) + 1]

        def one():
            job._call(c[0])
            c[0] += 1
        block = 3
    else:
        one, block = job._one, 8
    out["cost"] = cost(torch, one, block)
    out["block"] = block
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
