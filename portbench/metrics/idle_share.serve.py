"""idle_share.serve: the share of the profiled calls' wall time (host clock,
synchronised) in which no device event ran: 1 - (the union of the device's
event intervals) / (the slice's wall time)."""


def read(rec):
    if rec.get("job") != "serve" or rec["profile"]["wall_s"] <= 0:
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
