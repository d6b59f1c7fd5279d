"""decode_ms.serve: milliseconds a decode step of a call takes: (the call's
time less its prefill) / new tokens, the mean over the traced run's timed
calls. The call's time runs to its tokens on the host."""


def read(rec):
    if rec.get("job") != "serve" or not rec.get("call_s"):
        return None
    pre = rec["prefill_s"][-len(rec["call_s"]):]
    if len(pre) != len(rec["call_s"]):
        return None
    per = [(c - p) / rec["n_new"] for c, p in zip(rec["call_s"], pre)]
    return 1e3 * sum(per) / len(per)
