"""decode_roofline.serve: the share of its bound that a decode step reaches:
the bytes the step must move (`portbench/cost.py::decode_step_bytes`:
every weight once, an MoE layer's experts only as many as the step's
tokens are routed to by the benchmark's own reference, averaged over the
judged call's decode steps and layers; the KV cache over the positions
filled, averaged over the call's steps) over 3.35 TB/s, against
decode_ms.serve. The bytes set the bound (a step's FLOPs take a tenth of
the time at these batches)."""
from portbench import cost


def read(rec):
    if rec.get("job") != "serve" or not rec.get("call_s"):
        return None
    spec, B, P, n = rec["spec"], rec["batch"], rec["prompt"], rec["n_new"]
    experts = 0.0
    if spec.experts:
        experts = rec.get("judged", {}).get("experts_per_decode_step")
        if not experts:
            return None
    filled = P + (n + 1) / 2.0          # mean over steps of P + i + 1
    nbytes = cost.decode_step_bytes(spec, B, filled, experts)
    flops = cost.decode_step_flops(spec, B, filled)
    bound, _ = cost.bound_s(nbytes, flops, cost.HW["peak_flops_bf16"])
    pre = rec["prefill_s"][-len(rec["call_s"]):]
    if len(pre) != len(rec["call_s"]):
        return None
    step = sum((c - p) / n for c, p in zip(rec["call_s"], pre)) / len(pre)
    return 100.0 * bound / step
