"""ssd_scan_ms.serve: device milliseconds of a call's Mamba2 chunked scans:
the sum of the program's `ssm.scan` phase spans of a `generate` call (one a
Mamba2 layer of the prefill, read from their CUDA events), the mean over
the profiled calls. None where a call has not one span a layer."""
from portbench import spans


def read(rec):
    if rec.get("job") != "serve" or rec.get("model") != "zamba2":
        return None
    got = spans.named(rec, "serve.generate", "profile_calls", "ssm.scan",
                      rec.get("mamba_layers"))
    if got is None:
        return None
    return spans.mean([sum(spans.device_ms(s) for s in call)
                       for call in got])
