"""replay_ms.serve: device milliseconds of one of the program's
`serve.replay` phase spans (a replay of the captured decode step), read
from their CUDA events; the mean over the profiled calls' n_new replays
each."""
from portbench import spans


def read(rec):
    if rec.get("job") != "serve":
        return None
    got = spans.named(rec, "serve.generate", "profile_calls",
                      "serve.replay", rec.get("n_new"))
    if got is None:
        return None
    return spans.mean([spans.device_ms(s) for call in got for s in call])
