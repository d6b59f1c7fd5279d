"""update_ms.train: milliseconds a step spends outside loss_and_grads (the
global norm, the clip and AdamW's in-place update): the synchronised step
time less its loss_and_grads time, the mean over the traced run's timed
steps."""


def read(rec):
    if rec.get("job") != "train":
        return None
    steps, grads = rec.get("step_s") or [], rec.get("grads_s") or []
    if not steps or len(steps) != len(grads):
        return None
    return 1e3 * sum(s - g for s, g in zip(steps, grads)) / len(steps)
