"""shared_block_ms.serve: device milliseconds of a call's shared-block
calls: the sum of the program's `zamba2.shared` phase spans of a `generate`
call (one a call of a shared block in the prefill; the decode's run inside
its CUDA graph, unspanned), the mean over the profiled calls."""
from portbench import spans


def read(rec):
    if rec.get("job") != "serve" or rec.get("model") != "zamba2":
        return None
    got = spans.named(rec, "serve.generate", "profile_calls",
                      "zamba2.shared", rec.get("shared_calls"))
    if got is None:
        return None
    return spans.mean([sum(spans.device_ms(s) for s in call)
                       for call in got])
