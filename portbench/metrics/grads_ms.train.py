"""grads_ms.train: milliseconds a step spends in
`repro_torch.train.step.loss_and_grads` (both forwards, `kd_loss_grad`, the
backward), timed by the host around the call, synchronised on both sides;
the mean over the traced run's timed steps."""


def read(rec):
    if rec.get("job") != "train" or not rec.get("grads_s"):
        return None
    return 1e3 * sum(rec["grads_s"]) / len(rec["grads_s"])
