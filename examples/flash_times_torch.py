#!/usr/bin/env python3
"""Device time of the port's flash-attention kernels, forward and backward,
at a few shapes on one CUDA card: the same measurement as chip_smoke.py's
phases 6 and 12 (calls captured into one CUDA graph, replays timed with
CUDA events, inputs cycled over copies that spill the 50 MB L2).

It times whichever `repro_torch` is first on the path, so two checkouts
compare on one card by running this file against each in turns, e.g. a
parent checkout unpacked under build/ and this tree:

    PYTHONPATH=build/parent/src python3 examples/flash_times_torch.py --tag parent
    PYTHONPATH=src python3 examples/flash_times_torch.py --tag change

A shape whose head dim the package's kernels do not take is reported as
null. Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (its timing and input helpers)

#: (B, H, KV, S, hd, window, dtype, layout): the training and serving
#: paths' hd-128 and hd-64 shapes, and zamba2-7b's hd 112 beside hd 128 at
#: its B, H and S
SHAPES = [(4, 24, 8, 512, 128, 0, "bfloat16", "bshd"),
          (4, 4, 4, 512, 64, 0, "bfloat16", "bshd"),
          (4, 24, 24, 512, 64, 0, "bfloat16", "bshd"),
          (4, 32, 32, 512, 128, 0, "bfloat16", "bshd"),
          (4, 32, 32, 512, 112, 0, "bfloat16", "bshd")]


def time_shape(torch, fa, shape, iters):
    """{"fwd_ms", "bwd_ms"} of the kernels at `shape`."""
    B, H, KV, S, hd, window, dtype, layout = shape
    q, k, v = cs._flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
    elt = q.element_size()
    nxt = cs._cold_copies((q, k, v), (2 * B * H + 2 * B * KV) * S * hd * elt)
    fwd = cs._graph_ms(torch, lambda: fa.flash_attention(
        *nxt(), sliding_window=window), iters)
    o, lse = fa._launch(q, k, v, True, window, with_lse=True)
    do = torch.randn_like(o)
    nxt_b = cs._cold_copies((q, k, v, o, lse, do),
                            (4 * B * H + 4 * B * KV) * S * hd * elt)
    bwd = cs._graph_ms(torch, lambda: fa.flash_attention_bwd(
        *nxt_b(), sliding_window=window), iters)
    return {"fwd_ms": fwd, "bwd_ms": bwd}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tag", default="", help="a name for this checkout")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_times_torch: needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = []
    for shape in SHAPES:
        t = (time_shape(torch, fa, shape, args.iters)
             if shape[4] in fa.HEAD_DIMS else None)
        rows.append({"shape": list(shape), "times": t})
    print(json.dumps({"tag": args.tag, "package": fa.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
