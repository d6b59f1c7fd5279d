"""mfu.hybrid.serve: the zamba2 cell's whole call's model FLOPs
(`cost_zamba2.serve_call_flops`: the Mamba2 and shared-block products a
token runs, the head where a token is produced, causal attention over each
call's prefix, the recurrence) over the call's time and 989 TFLOP/s, the
mean over the traced run's timed calls."""
from portbench import cost, cost_zamba2


def read(rec):
    if (rec.get("job") != "serve" or rec.get("model") != "zamba2"
            or not rec.get("call_s")):
        return None
    flops = cost_zamba2.serve_call_flops(rec["spec"], rec["batch"],
                                         rec["prompt"], rec["n_new"])
    sec = sum(rec["call_s"]) / len(rec["call_s"])
    return 100.0 * flops / (sec * cost.HW["peak_flops_bf16"])
