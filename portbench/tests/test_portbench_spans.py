"""The span metrics' readers on synthetic span logs in place of the
program's `repro_torch.obs.trace.profiled()`: each reads its number from
the first profiled steps or calls alone, and None where the program has no
such function (an older program), where the counts are not those the
cells give, or where the spans carry no device interval (off CUDA)."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.reference.model import Spec

DENSE = Spec(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, ff=16, vocab=10)
MOE = Spec(layers=3, d=8, heads=2, kv_heads=1, head_dim=4, ff=0, vocab=10,
           experts=4, top_k=2, moe_ff=6)


class Log:
    """A span log as `profiled()` gives it: spans in entry order, device
    intervals in ms from their root's start."""

    def __init__(self):
        self.spans, self.seq = [], 0

    def add(self, name, root, host, device):
        s = {"name": name, "seq": self.seq,
             "root": self.seq if root is None else root["seq"],
             "depth": 0 if root is None else 1, "host": host,
             "device": device, "args": {}}
        self.seq += 1
        self.spans.append(s)
        return s


def train_log(steps, moe_spans=0, backward=1, device=True):
    """`steps` train.step spans: step i takes 100 + i host ms and 200 + 2 i
    device ms; loss_and_grads 120 + i, backward 80 + i, update 70 + i
    device ms; each moe.layer 3 device ms."""
    log = Log()
    for i in range(steps):
        t = 10.0 * i
        root = log.add("train.step", None, (t, t + (100 + i) / 1e3),
                       (0.0, 200.0 + 2 * i) if device else None)
        log.add("train.loss_and_grads", root, (t, t + 0.05),
                (1.0, 121.0 + i) if device else None)
        for _ in range(moe_spans):
            log.add("moe.layer", root, (t, t + 0.001),
                    (5.0, 8.0) if device else None)
        for _ in range(backward):
            log.add("train.backward", root, (t, t + 0.04),
                    (30.0, 110.0 + i) if device else None)
        log.add("train.update", root, (t + 0.05, t + 0.09),
                (125.0, 195.0 + i) if device else None)
    return log.spans


def serve_log(calls, n_new, prefills=1):
    """`calls` serve.generate spans: prefill 500 + c device ms, replays of
    40 + c ms each 1 ms apart."""
    log = Log()
    for c in range(calls):
        t = 10.0 * c
        root = log.add("serve.generate", None, (t, t + 3.0), (0.0, 3200.0))
        for _ in range(prefills):
            log.add("serve.prefill", root, (t, t + 0.5), (0.0, 500.0 + c))
        log.add("moe.layer", root, (t, t + 0.01), (1.0, 2.0))
        at = 600.0
        for _ in range(n_new):
            log.add("serve.replay", root, (t, t + 0.001),
                    (at, at + 40.0 + c))
            at += 41.0 + c
    return log.spans


TRAIN_REC = {"job": "train", "profile_steps": 2, "specs": [MOE, DENSE],
             "remat": True}
SERVE_REC = {"job": "serve", "profile_calls": 2, "n_new": 4}


@pytest.fixture
def program(monkeypatch):
    """Set the span log the readers see; None takes the function away."""
    from repro_torch.obs import trace

    def use(spans):
        if spans is None:
            monkeypatch.delattr(trace, "profiled")
        else:
            monkeypatch.setattr(trace, "profiled", lambda: spans,
                                raising=False)
    return use


def read(metric, rec):
    return harness.load_module("metrics", metric).read(dict(rec))


# (metric, record, log, its number): the third step or call, profiled
# with the host traced, is left out
CASES = [
    ("grads_span_ms.train", TRAIN_REC, train_log(3, 6), (120 + 121) / 2),
    ("backward_span_ms.train", TRAIN_REC, train_log(3, 6), (80 + 81) / 2),
    ("update_span_ms.train", TRAIN_REC, train_log(3, 6), (70 + 71) / 2),
    ("host_issue_share.train", TRAIN_REC, train_log(3, 6),
     (100 * 100 / 200 + 100 * 101 / 202) / 2),
    ("moe_fwd_ms.train", TRAIN_REC, train_log(3, 6), 6 * 3.0),
    ("prefill_span_ms.serve", SERVE_REC, serve_log(3, 4), (500 + 501) / 2),
    ("replay_ms.serve", SERVE_REC, serve_log(3, 4), (40 + 41) / 2),
    ("replay_gap_ms.serve", SERVE_REC, serve_log(3, 4), 1.0),
]


@pytest.mark.parametrize("metric,rec,spans,want", CASES,
                         ids=[c[0] for c in CASES])
def test_span_reader(program, metric, rec, spans, want):
    program(spans)
    assert read(metric, rec) == pytest.approx(want)
    program(None)                        # an older program: no spans
    assert read(metric, rec) is None
    program([])
    assert read(metric, rec) is None
    other = "serve" if rec["job"] == "train" else "train"
    program(spans)
    assert read(metric, dict(rec, job=other)) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES[:5]])
def test_train_span_readers_need_the_stated_counts(program, metric):
    program(train_log(1, 6))             # fewer steps than profiled
    assert read(metric, TRAIN_REC) is None
    program(train_log(3, 6, device=False))   # off CUDA
    assert read(metric, TRAIN_REC) is None


def test_train_span_counts_per_metric(program):
    program(train_log(3, 6, backward=2))     # a chunked loss: two
    assert read("backward_span_ms.train", TRAIN_REC) is None
    assert read("grads_span_ms.train", TRAIN_REC) is not None
    program(train_log(3, 3))                 # remat's second forwards lost
    assert read("moe_fwd_ms.train", TRAIN_REC) is None
    assert read("moe_fwd_ms.train", dict(TRAIN_REC, remat=False)) == \
        pytest.approx(3 * 3.0)
    program(train_log(3, 0))
    assert read("moe_fwd_ms.train", dict(TRAIN_REC, specs=[DENSE])) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES[5:]])
def test_serve_span_readers_need_the_stated_counts(program, metric):
    program(serve_log(3, 3))                 # 3 replays, not n_new 4
    if metric != "prefill_span_ms.serve":
        assert read(metric, SERVE_REC) is None
    program(serve_log(3, 4, prefills=2))
    if metric == "prefill_span_ms.serve":
        assert read(metric, SERVE_REC) is None
    program(serve_log(1, 4))                 # fewer calls than profiled
    assert read(metric, SERVE_REC) is None
