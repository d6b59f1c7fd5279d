"""The port's phase spans (`repro_torch.obs.trace.phase`) on the CPU: off,
a span is the shared null span and records nothing; it records under a
torch.profiler session (into `profiled()`, with no `record_function`
range) and under an enabled tracer (a wall span and a `record_function`
range); spans nest; the profiled buffer is bounded; the train step, the MoE
layer and the serve engine give the stated spans; the Chrome export stays
valid. The device side (CUDA events, graph capture, no sync) is held on a
card by tests/test_torch_gpu.py.
"""
from collections import Counter
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.api import dummy_batch, init_model
from repro_torch.obs import trace
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import cache_bytes
from repro_torch.train.step import (TrainStepConfig, make_hapfl_train_step,
                                    make_train_state)
from repro_torch.utils.pytree import tree_leaves


@pytest.fixture(autouse=True)
def _clean():
    trace.disable()
    trace.profiled(clear=True)
    yield
    trace.disable()
    trace.profiled(clear=True)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return Counter(s["name"] for s in spans)


def test_span_off_is_the_shared_null_span_and_records_nothing():
    span = trace.phase("off", k=1)
    assert span is trace.phase("other")
    assert not span.recording
    with span as s:
        assert s is span
    assert trace.profiled() == []
    assert trace.current() is trace.NULL_TRACER


def test_span_records_under_a_profiler_without_a_range():
    with _cpu_profile() as prof:
        with trace.phase("probe.profiled", n=3) as span:
            assert span.recording
    got = trace.profiled()
    assert [s["name"] for s in got] == ["probe.profiled"]
    rec = got[0]
    assert rec["args"] == {"n": 3} and rec["depth"] == 0
    assert rec["root"] == rec["seq"] and rec["device"] is None
    assert rec["host"][1] >= rec["host"][0]
    assert "probe.profiled" not in {e.name for e in prof.events()}


def test_span_records_under_enable_with_a_range():
    tracer = trace.enable(trace.Tracer())
    with _cpu_profile() as prof:
        with trace.phase("probe.enabled", k="v"):
            pass
    trace.disable()
    assert "probe.enabled" in {e.name for e in prof.events()}
    walls = [e for e in tracer.events if e["name"] == "probe.enabled"]
    assert len(walls) == 1 and walls[0]["tid"] == "torch"
    assert walls[0]["args"] == {"k": "v"}
    # the profiler ran too, so the span is in the profiled buffer as well
    assert _names(trace.profiled()) == {"probe.enabled": 1}
    trace.profiled(clear=True)

    tracer = trace.enable(trace.Tracer())
    with trace.phase("probe.enabled.only"):
        pass
    trace.disable()
    assert trace.profiled() == []
    assert [p.name for p in tracer.phases] == ["probe.enabled.only"]
    chrome = tracer.to_chrome()
    trace.validate_chrome_trace(chrome)
    assert isinstance(chrome["otherData"]["epoch_ns_at_ts0"], int)


def test_spans_nest():
    with _cpu_profile():
        with trace.phase("outer"):
            with trace.phase("mid"):
                with trace.phase("inner"):
                    pass
            with trace.phase("mid"):
                pass
        with trace.phase("next"):
            pass
    got = trace.profiled()
    assert [s["name"] for s in got] == ["outer", "mid", "inner", "mid",
                                        "next"]
    assert [s["depth"] for s in got] == [0, 1, 2, 1, 0]
    outer, nxt = got[0], got[4]
    assert [s["root"] for s in got] == [outer["seq"]] * 4 + [nxt["seq"]]
    for child in got[1:4]:
        assert outer["host"][0] <= child["host"][0]
        assert child["host"][1] <= outer["host"][1]
    assert got[2]["host"][1] <= got[1]["host"][1]


def test_profiled_buffer_is_bounded_and_keeps_the_newest():
    n = trace.PROFILED_MAX + 7
    with _cpu_profile():
        for i in range(n):
            with trace.phase("many", i=i):
                pass
    got = trace.profiled(clear=True)
    assert len(got) == trace.PROFILED_MAX
    assert [s["args"]["i"] for s in got] == list(range(7, n))
    assert trace.profiled() == []


def _train_state(arch, **tweaks):
    cfg = replace(get_config(arch).smoke(), **tweaks)
    lite = cfg.lite()
    state = make_train_state(torch.Generator().manual_seed(0), cfg, lite,
                             device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             dummy_batch(cfg, 2, 16, device="cpu").items()}
    return cfg, lite, state, batch


@pytest.mark.parametrize("arch,remat,chunk", [
    ("llama3.2-3b", False, 0), ("llama3.2-3b", True, 8),
    ("qwen3-moe-30b-a3b", False, 0), ("qwen3-moe-30b-a3b", True, 0),
    ("qwen3-moe-30b-a3b", True, 4)])
def test_train_step_spans(arch, remat, chunk):
    cfg, lite, state, batch = _train_state(arch, remat=remat)
    step = make_hapfl_train_step(cfg, replace(lite, remat=remat),
                                 TrainStepConfig(loss_chunk=chunk))
    with _cpu_profile():
        step(state, batch)
    got = trace.profiled()
    moe_layers = cfg.n_layers if cfg.is_moe else 0
    chunks = 16 // chunk if chunk else 0
    want = {"train.step": 1, "train.loss_and_grads": 1,
            "train.backward": chunks + 1, "train.update": 1}
    if moe_layers:
        want["moe.layer"] = (1 + remat) * moe_layers
    assert _names(got) == want
    root = got[0]
    assert root["name"] == "train.step" and root["depth"] == 0
    assert all(s["root"] == root["seq"] for s in got)
    depth = {s["name"]: s["depth"] for s in got}
    assert depth["train.loss_and_grads"] == depth["train.update"] == 1
    assert depth["train.backward"] == 2
    # remat runs each MoE layer's forward again inside the backward
    last_bwd = [s for s in got if s["name"] == "train.backward"][-1]
    inside = [s for s in got if s["name"] == "moe.layer"
              and s["seq"] > last_bwd["seq"]]
    assert len(inside) == (moe_layers if remat else 0)


def test_microbatched_step_gives_a_grads_span_a_microbatch():
    cfg, lite, state, batch = _train_state("llama3.2-3b")
    step = make_hapfl_train_step(cfg, lite, TrainStepConfig(microbatch=2))
    with _cpu_profile():
        step(state, batch)
    assert _names(trace.profiled()) == {
        "train.step": 1, "train.loss_and_grads": 2, "train.backward": 2,
        "train.update": 1}


def test_traced_step_is_the_untraced_step():
    """Spans observe: a step with them recording changes no bit."""
    outs = []
    for traced in (False, True):
        cfg, lite, state, batch = _train_state("qwen3-moe-30b-a3b",
                                               remat=True)
        step = make_hapfl_train_step(cfg, replace(lite, remat=True))
        if traced:
            trace.enable(trace.Tracer())
        state, m = step(state, batch)
        trace.disable()
        outs.append((float(m["loss"]), tree_leaves(state["params"])))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b"])
def test_generate_spans(arch):
    cfg = get_config(arch).smoke()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    n_new = 5
    with _cpu_profile():
        eng.generate({"tokens": toks}, n_new=n_new)
    got = trace.profiled()
    names = _names(got)
    assert names["serve.generate"] == 1 and names["serve.prefill"] == 1
    assert names["serve.replay"] == n_new
    # eager on the CPU: the prefill's and every step's MoE layers
    assert names.get("moe.layer", 0) == (
        cfg.n_layers * (1 + n_new) if cfg.is_moe else 0)
    assert got[0]["name"] == "serve.generate"
    # the decode cache's bytes and the call's decode-attention launches
    # (none on the CPU); the allocator's counts are a card's only
    assert got[0]["args"] == {**cache_bytes(eng.decode_step_for(2).cache),
                              "decode_attention": 0}
    assert got[0]["args"]["kv_bytes"] > 0
    replays = [s for s in got if s["name"] == "serve.replay"]
    assert all(a["host"][1] <= b["host"][0]
               for a, b in zip(replays, replays[1:]))


def test_generate_returns_the_prompt_argmax_on_request():
    cfg = get_config("llama3.2-3b").smoke()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 6))
    plain = eng.generate({"tokens": toks}, n_new=4)
    got, first = eng.generate({"tokens": toks}, n_new=4, return_first=True)
    got2, logits, first2 = eng.generate({"tokens": toks}, n_new=4,
                                        return_logits=True,
                                        return_first=True)
    assert np.array_equal(plain, got) and np.array_equal(plain, got2)
    assert logits.shape[:2] == (3, 4)
    from repro_torch.models.api import prefill
    pre, _ = prefill(params, cfg, {"tokens": torch.as_tensor(toks)})
    want = pre[:, -1].argmax(-1).numpy()
    assert first.shape == (3,) and np.array_equal(first, want)
    assert np.array_equal(first2, want)
