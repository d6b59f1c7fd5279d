#!/usr/bin/env python3
"""Device time of the port's kd_loss forward and backward kernels
(`kd_loss_fwd`, `kd_loss_bwd`) at a few shapes on one CUDA card: the same
measurement as chip_smoke.py's phase 6 (calls captured into one CUDA graph,
replays timed with CUDA events, inputs cycled over copies that spill the
50 MB L2), with each time's share of its bound (`kernels/cost.py`), and
the eager wall time per call on one set of inputs, as phase 6 takes it;
and `kd_loss_grad`'s device time, as phases 6 and 12 take it (one set of
inputs).

It times whichever `repro_torch` is first on the path, so two checkouts
compare on one card by running this file against each in turns, e.g. a
parent checkout unpacked under build/ and this tree:

    PYTHONPATH=build/parent/src python3 examples/kd_times_torch.py --tag parent
    PYTHONPATH=src python3 examples/kd_times_torch.py --tag change

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (its timing and input helpers)

#: (N, V, dtype): the HAPFL path's rows, the vocabulary shape in both
#: dtypes, chip_smoke.py 13c's rank rows and a few such rows
SHAPES = [(128, 10, "float32"), (2048, 32000, "float32"),
          (2048, 32000, "bfloat16"), (1024, 151936, "bfloat16"),
          (64, 151936, "bfloat16")]
#: kd_loss_grad (C, B, V, dtype): the HAPFL step's, the vocabulary shape in
#: both dtypes, and the training steps' (llama3.2-3b's, qwen3-moe's and
#: qwen2-vl's, the latter also in bf16, xlstm-1.3b's, zamba2-7b's and
#: musicgen-medium's)
GRAD_SHAPES = [(4, 32, 10, "float32"), (4, 512, 32000, "float32"),
               (4, 512, 32000, "bfloat16"), (1, 2048, 128256, "float32"),
               (1, 2048, 151936, "float32"), (1, 2048, 151936, "bfloat16"),
               (1, 2048, 50304, "float32"), (1, 2048, 32000, "float32"),
               (1, 8192, 2048, "float32")]
#: calls a timing at a vocabulary shape, ten times as many below 1e6
#: elements, as chip_smoke.py's phase 6
ITERS = 20


def time_shape(torch, kd, cost, shape):
    """{"fwd_ms", "bwd_ms", "fwd_eager_ms", "bwd_eager_ms", "fwd_bound_ms",
    "bwd_bound_ms", "fwd_share", "bwd_share"} of the kernels at `shape`."""
    N, V, dtype = shape
    fwd_in, bwd_in = cs.kd_inputs_cold(torch, N, V, dtype)
    fwd_one, bwd_one = fwd_in(), bwd_in()
    n = ITERS if N * V >= 1e6 else 10 * ITERS
    out = {"fwd_ms": cs._graph_ms(torch, lambda: kd.kd_loss_fwd(*fwd_in()), n),
           "bwd_ms": cs._graph_ms(torch, lambda: kd.kd_loss_bwd(*bwd_in()), n),
           "fwd_eager_ms": cs._eager_ms(
               torch, lambda: kd.kd_loss_fwd(*fwd_one), n),
           "bwd_eager_ms": cs._eager_ms(
               torch, lambda: kd.kd_loss_bwd(*bwd_one), n)}
    bounds = cost.kd_bounds(N, V, 2 if dtype == "bfloat16" else 4)
    for key, name in (("fwd", "kd_loss_fwd"), ("bwd", "kd_loss_bwd")):
        out[f"{key}_bound_ms"] = bounds[name][0]
        out[f"{key}_share"] = bounds[name][0] / out[f"{key}_ms"]
    return out


def time_grad(torch, kd, cost, shape):
    """{"ms", "bound_ms", "share"} of kd_loss_grad at `shape`."""
    C, B, V, dtype = shape
    x, y, lab = cs._grad_inputs(torch, C, B, V, dtype, seed=7)
    n = ITERS if C * B * V >= 1e6 else 10 * ITERS
    ms = cs._graph_ms(torch, lambda: kd.kd_loss_grad(x, y, lab, cs.LAMBDAS),
                      n)
    bound = cost.grad_bound(C, B, V, x.element_size())[0]
    return {"ms": ms, "bound_ms": bound, "share": bound / ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tag", default="", help="a name for this checkout")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kd_times_torch: needs a CUDA card")
    from repro_torch.kernels import cost
    from repro_torch.kernels import kd_loss as kd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = [{"shape": list(shape),
             "times": time_shape(torch, kd, cost, shape)}
            for shape in SHAPES]
    rows += [{"shape": list(shape),
              "kd_loss_grad": time_grad(torch, kd, cost, shape)}
             for shape in GRAD_SHAPES]
    print(json.dumps({"tag": args.tag, "package": kd.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
