"""mfu.serve: the whole call's model FLOPs (`portbench/cost.py`: 2 x the
parameters a token's blocks touch for every prompt and generated token, the
head for the prompt's last position and each generated token, causal
attention over each position's prefix) over the call's time and 989
TFLOP/s, the mean over the traced run's timed calls."""
from portbench import cost


def read(rec):
    if rec.get("job") != "serve" or not rec.get("call_s"):
        return None
    flops = cost.serve_call_flops(rec["spec"], rec["batch"], rec["prompt"],
                                  rec["n_new"])
    sec = sum(rec["call_s"]) / len(rec["call_s"])
    return 100.0 * flops / (sec * cost.HW["peak_flops_bf16"])
