"""roofline.kd_loss_grad.train: the share of its bound that the step's
`kd_loss_grad` kernel reaches. One launch a step on (1, B S, V) fp32 logits
of both models; the bound is the larger of its bytes over 3.35 TB/s and its
fp32 operations over 67 TFLOP/s (the bytes set it), frozen in
`portbench/cost.py`; the time is the kernel's device time in the profiled
steps."""
from portbench import cost, harness


def read(rec):
    if rec.get("job") != "train":
        return None
    n, sec = harness.kernel_time(rec["profile"], lambda k: "kd_grad" in k)
    if not n or sec <= 0:
        return None
    spec = rec["specs"][0]
    nbytes, ops = cost.grad_work(1, rec["batch"] * rec["seq"], spec.vocab, 4)
    bound, _ = cost.bound_s(nbytes, ops, cost.HW["peak_flops_fp32"])
    return 100.0 * n * bound / sec
