"""roofline.flash_attention.serve: the share of their bound that the
prefill's flash attention launches reach, one a shared-block call (hd 224
at the zamba2 cell): each launch's bound is the larger of its causal pairs'
FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s (`cost.flash_work`;
the bytes set it at (32, 32, 512, 224)), over their profiled device time.
None where the profile's launch count is not one a call."""
from portbench import cost, harness


def _fwd(k):
    return "flash_" in k and "flash_bwd" not in k


def read(rec):
    if rec.get("job") != "serve" or rec.get("model") != "zamba2":
        return None
    n, t = harness.kernel_time(rec["profile"], _fwd)
    calls = rec["profile_calls"] * rec["shared_calls"]
    if n != calls or t <= 0:
        return None
    s = rec["spec"]
    one, _ = cost.bound_s(*cost.flash_work(
        rec["batch"], s.heads, s.kv_heads, rec["prompt"], s.head_dim, 2),
        cost.HW["peak_flops_bf16"])
    return 100.0 * calls * one / t
