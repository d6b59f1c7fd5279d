"""backward_span_ms.train: device milliseconds of the program's
`train.backward` phase span (the `torch.autograd.grad` call, remat's
recomputed forwards included), one a step as no cell sets `loss_chunk`,
read from its CUDA events in the profiled steps; the mean over those
steps."""
from portbench import spans


def read(rec):
    if rec.get("job") != "train":
        return None
    got = spans.named(rec, "train.step", "profile_steps", "train.backward",
                      1)
    if got is None:
        return None
    return spans.mean([spans.device_ms(s[0]) for s in got])
