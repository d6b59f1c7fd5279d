"""roofline.flash_attention.train: the share of their bound that the step's
flash attention kernels reach, forward and backward together. Each model's
layers launch the forward once, and once more in the backward's
recomputation when the step rematerialises, and the backward once; each
launch's bound is the larger of its causal pairs' FLOPs over 989 TFLOP/s
and its bytes over 3.35 TB/s (the FLOPs set it at these shapes). None where
the profile's launch counts are not those."""
from portbench import cost, harness


def _fwd(k):
    return "flash_" in k and "flash_bwd" not in k


def _bwd_call(k):
    return "flash_bwd_prep" in k or "flash_bwd_delta" in k


def read(rec):
    if rec.get("job") != "train":
        return None
    prof, steps = rec["profile"], rec["profile_steps"]
    n_fwd, t_fwd = harness.kernel_time(prof, _fwd)
    n_bwd, _ = harness.kernel_time(prof, _bwd_call)
    _, t_bwd = harness.kernel_time(prof, lambda k: "flash_bwd" in k)
    per_layer_fwd = 2 if rec.get("remat", True) else 1
    want_fwd = steps * per_layer_fwd * sum(s.layers for s in rec["specs"])
    want_bwd = steps * sum(s.layers for s in rec["specs"])
    if n_fwd != want_fwd or n_bwd != want_bwd or t_fwd + t_bwd <= 0:
        return None
    B, S, bound = rec["batch"], rec["seq"], 0.0
    for s in rec["specs"]:
        args = (B, s.heads, s.kv_heads, S, s.head_dim, 2)
        f, _ = cost.bound_s(*cost.flash_work(*args),
                            cost.HW["peak_flops_bf16"])
        b, _ = cost.bound_s(*cost.flash_bwd_work(*args),
                            cost.HW["peak_flops_bf16"])
        bound += steps * s.layers * (per_layer_fwd * f + b)
    return 100.0 * bound / (t_fwd + t_bwd)
