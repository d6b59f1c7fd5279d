"""Readings that set a cell's limits, on the card at the cell's own sizes:
for each seed, the program's compared numbers against the reference and,
with --control, the lower-precision control's (the reference in float8 in
the program's place) and the planted faults' readings: for a training
cell, half of each batch left out (the mean taken over the rest) and the
state left unchanged (lr 0); for a serving cell, one served token altered.
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--control] [--seconds 2]

One JSON line a seed on standard output. Each reading (the program's, the
control's, each fault's) is also put through the harness's own comparison,
`harness.Checks` with the cell's limits, as a run judges it: the reading
carries "correct", and standard error has a line for each, with every
number beside its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def train_readings(job, control: bool) -> dict:
    job.setup()
    prog = job.readings()
    job.free()
    t0 = time.perf_counter()
    ref = job.reference()
    out = {"program": job.numbers(prog, ref, detail=True),
           "reference_s": time.perf_counter() - t0,
           "losses": {"program": prog["losses"], "reference": ref["losses"]},
           "terms1": {"program": prog["terms"][0],
                      "reference": ref["terms"][0]}}
    if control:
        out["control_fp8"] = job.numbers(job.reference("fp8"), ref, True)
        out["fault_half_batch"] = job.numbers(
            job.reference(half_batch=True), ref, True)
        out["fault_unchanged"] = job.numbers(
            job.reference(hp=dict(job.hp, lr=0.0)), ref, True)
    return out


def serve_readings(job, control: bool, seconds: float) -> dict:
    job.setup()
    job.window(seconds)
    job.free()
    c = job.sample()
    t0 = time.perf_counter()
    ref = job.reference(c)
    out = {"program": job.numbers(ref, job.served(c)),
           "reference_s": time.perf_counter() - t0, "call": c}
    if control:
        low = job.reference(c, "fp8")
        out["control_fp8"] = job.numbers(ref, low.argmax(-1))
        altered = job.served(c).clone()
        altered[0, 5] = (altered[0, 5] + 12345) % job.spec.vocab
        out["fault_altered_token"] = job.numbers(ref, altered)
    return out


def judged(out: dict, limits: dict, seed: int) -> None:
    """Add "correct" to each reading of `out`, as `harness.Checks` decides
    it with the cell's limits, and print each beside its limits."""
    from portbench import harness
    for name, nums in out.items():
        if not (isinstance(nums, dict) and set(limits) <= set(nums)):
            continue
        checks = harness.Checks()
        for k, lim in limits.items():
            checks.add(k, nums[k], lim)
        nums["correct"] = checks.correct()
        print(f"control: seed {seed} {name}: correct {nums['correct']} ("
              + ", ".join(f"{k} {nums[k]!r} limit {lim!r}"
                          for k, lim in limits.items()) + ")",
              file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    for seed in args.seeds:
        ctx = SimpleNamespace(torch=torch, device=torch.device("cuda", 0),
                              seed=seed, seconds=args.seconds, trace=0,
                              cell=cell, config=config,
                              since_start=lambda: 0.0)
        job = harness.load_module("jobs", cell["job"]).make(ctx)
        t0 = time.perf_counter()
        if cell["job"] == "train":
            out = train_readings(job, args.control)
        else:
            out = serve_readings(job, args.control, args.seconds)
        judged(out, cell["limits"], seed)
        out.update(seed=seed, workload=args.workload,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        del job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
