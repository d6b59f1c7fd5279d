"""decode_roofline.hybrid.serve: the share of its bound that a decode step
of the zamba2 cell reaches: the bytes the step must move
(`cost_zamba2.decode_step_bytes`: every weight once, a shared block's at
each of its calls, the fp32 SSM state read and written, the conv
windows, each call's KV over the filled
positions, averaged over the call's steps) over 3.35 TB/s, against the
mean device time of the profiled calls' `serve.replay` spans. The bytes set
the bound: the step's FLOPs take a tenth of the time."""
from portbench import cost, cost_zamba2, spans


def read(rec):
    if rec.get("job") != "serve" or rec.get("model") != "zamba2":
        return None
    got = spans.named(rec, "serve.generate", "profile_calls",
                      "serve.replay", rec.get("n_new"))
    if got is None:
        return None
    step_ms = spans.mean([spans.device_ms(s) for call in got for s in call])
    filled = rec["prompt"] + (rec["n_new"] + 1) / 2.0
    nbytes = cost_zamba2.decode_step_bytes(rec["spec"], rec["batch"], filled)
    return 100.0 * nbytes / cost.HW["hbm_bw"] / (step_ms / 1e3)
