"""moe_fwd_ms.train: device milliseconds a step of the program's
`moe.layer` phase spans (each eager `apply_moe` call: every MoE layer's
forward, and with remat its forward again in the backward), read from
their CUDA events in the profiled steps; the mean over those steps. None
unless a step holds (1 + remat) x the MoE layers of both models."""
from portbench import spans


def read(rec):
    if rec.get("job") != "train":
        return None
    layers = sum(s.layers for s in rec.get("specs", ()) if s.experts)
    if not layers:
        return None
    got = spans.named(rec, "train.step", "profile_steps", "moe.layer",
                      (1 + bool(rec.get("remat"))) * layers)
    if got is None:
        return None
    return spans.mean([sum(spans.device_ms(s) for s in step)
                       for step in got])
