"""mfu.train: the whole step's model FLOPs (`portbench/cost.py`:
6 x the parameters a token's forward touches in both models, no embedding
table, an MoE layer's top-k experts, plus three times causal attention; no
recomputation) over the synchronised step time and 989 TFLOP/s, the mean
over the traced run's timed steps."""
from portbench import cost


def read(rec):
    if rec.get("job") != "train" or not rec.get("step_s"):
        return None
    flops = cost.train_step_flops(rec["specs"], rec["batch"], rec["seq"])
    sec = sum(rec["step_s"]) / len(rec["step_s"])
    return 100.0 * flops / (sec * cost.HW["peak_flops_bf16"])
