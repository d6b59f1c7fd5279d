"""host_issue_share.train: 100 x the host milliseconds of the program's
`train.step` phase span over its device milliseconds (CUDA events), the
mean over the profiled steps. Each step starts on an empty queue (the loop
reads the loss on the host), so near 100 the host issuing the step sets
its pace; well under 100 the card does."""
from portbench import spans


def read(rec):
    if rec.get("job") != "train":
        return None
    got = spans.sessions(rec, "train.step", "profile_steps")
    if got is None:
        return None
    return spans.mean([100.0 * spans.host_ms(s[0]) / spans.device_ms(s[0])
                       for s in got])
