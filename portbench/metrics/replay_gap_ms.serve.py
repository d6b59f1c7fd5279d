"""replay_gap_ms.serve: device milliseconds from one `serve.replay` phase
span's end event to the next one's start event (the host's work between
two replays of the decode step: setting the position, copying the token
out), the mean over the profiled calls' n_new - 1 gaps each."""
from portbench import spans


def read(rec):
    if rec.get("job") != "serve":
        return None
    n = rec.get("n_new") or 0
    got = spans.named(rec, "serve.generate", "profile_calls",
                      "serve.replay", n)
    if got is None or n < 2:
        return None
    return spans.mean([b["device"][0] - a["device"][1]
                       for call in got for a, b in zip(call, call[1:])])
