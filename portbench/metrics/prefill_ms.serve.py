"""prefill_ms.serve: milliseconds of the engine's prefill call (the
prompt's forward, building the cache), timed by the host around it,
synchronised on both sides; the mean over the traced run's timed calls."""


def read(rec):
    if rec.get("job") != "serve" or not rec.get("prefill_s"):
        return None
    pre = rec["prefill_s"][-len(rec["call_s"]):]
    return 1e3 * sum(pre) / len(pre)
