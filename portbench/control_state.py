"""`control.py`'s readings for a cell whose program carries the prompt's
recurrent state into the decode (the zamba2 cell's job, `serve_zamba2`),
with one more planted fault: the decode from a zeroed state, which is
`generate` with the configuration's `carry_prompt_state` off
(`Job.served_zero_state`). The benchmark's own runs never run this.

    python3 portbench/control_state.py --workload zamba2-serve \
        --seeds 1 2 3 [--control] [--seconds 2]

One JSON line a seed on standard output, as `control.py` prints it, with
"fault_zero_state" beside "fault_altered_token" under --control; each
reading judged with the cell's limits (`control.judged`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def readings(job, control: bool, seconds: float) -> dict:
    job.setup()
    job.window(seconds)
    c = job.sample()
    zero = job.served_zero_state(c) if control else None
    job.free()
    t0 = time.perf_counter()
    ref = job.reference(c)
    out = {"program": job.numbers(ref, job.served(c)),
           "reference_s": time.perf_counter() - t0, "call": c}
    if control:
        out["control_fp8"] = job.numbers(ref, job.reference(c, "fp8")
                                         .argmax(-1))
        altered = job.served(c).clone()
        altered[0, 5] = (altered[0, 5] + 12345) % job.spec.vocab
        out["fault_altered_token"] = job.numbers(ref, altered)
        out["fault_zero_state"] = job.numbers(ref, zero)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import control, harness
    if not torch.cuda.is_available():
        print("control_state: no CUDA card", file=sys.stderr)
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
        out = readings(job, args.control, args.seconds)
        control.judged(out, cell["limits"], seed)
        out.update(seed=seed, workload=args.workload,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        del job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
