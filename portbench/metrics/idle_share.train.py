"""idle_share.train: the share of the profiled training steps' wall time
(host clock, synchronised) in which no device event ran: 1 - (the union of
the device's event intervals) / (the slice's wall time)."""


def read(rec):
    if rec.get("job") != "train" or rec["profile"]["wall_s"] <= 0:
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
