"""prefill_span_ms.serve: device milliseconds of the program's
`serve.prefill` phase span (the prompt's forward and its cache), one a
`generate` call, read from its CUDA events in the profiled calls; the mean
over those calls."""
from portbench import spans


def read(rec):
    if rec.get("job") != "serve":
        return None
    got = spans.named(rec, "serve.generate", "profile_calls",
                      "serve.prefill", 1)
    if got is None:
        return None
    return spans.mean([spans.device_ms(s[0]) for s in got])
