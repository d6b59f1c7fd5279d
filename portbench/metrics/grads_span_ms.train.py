"""grads_span_ms.train: device milliseconds of the program's
`train.loss_and_grads` phase span (both forwards, `kd_loss_grad`, the
backward), one a step, read from its CUDA events in the profiled steps
(no sync added); the mean over those steps."""
from portbench import spans


def read(rec):
    if rec.get("job") != "train":
        return None
    got = spans.named(rec, "train.step", "profile_steps",
                      "train.loss_and_grads", 1)
    if got is None:
        return None
    return spans.mean([spans.device_ms(s[0]) for s in got])
