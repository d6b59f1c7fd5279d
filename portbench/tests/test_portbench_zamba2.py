"""The zamba2 cell's files on the CPU: the frozen arithmetic against the
program's own count of the published model, the cell's per-layer readers
on synthetic span logs and profiles (None for another model's record, for
missing spans and off CUDA), and its job at a tiny size: the timed path
agrees with the reference, and the decode from a zeroed state reads over
the cell's limits."""
from __future__ import annotations

import copy

import pytest

from portbench import control_state, cost, cost_zamba2, harness
from portbench.reference import zamba2 as Z
from portbench.run import execute
from portbench.tests import helpers
from portbench.tests.test_portbench_spans import (  # noqa: F401
    Log, program, read)

SPEC = Z.from_config(harness.load_json("configs", "zamba2-7b-instruct"))
CELL = "zamba2-serve"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's CPU tests run: several test
    workers run at once."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arithmetic_at_the_published_config():
    """Weights: two bytes a parameter of the program's count (7.357 B),
    four for A_log, dt_bias and D; a decode step at batch 32 over the
    call's mean 544.5 filled positions moves 38.31 GB, 11.44 ms at 3.35
    TB/s: 30.96 GB with each weight once, and each of the 13 calls reads
    its shared block's 0.668 GB again."""
    from repro_torch.configs import get_config
    n = get_config("zamba2-7b-instruct").num_params()
    assert n == 7_356_749_648
    extra = 2 * 3 * SPEC.mamba_heads * SPEC.layers
    assert cost_zamba2.weight_bytes(SPEC) == 2 * n + extra
    step = cost_zamba2.decode_step_bytes(SPEC, 32, 544.5)
    assert step == pytest.approx(38.311e9, rel=1e-4)
    assert cost_zamba2.block_bytes(SPEC) == pytest.approx(0.668e9, rel=1e-3)
    assert step - 11 * cost_zamba2.block_bytes(SPEC) == pytest.approx(
        30.964e9, rel=1e-4)
    assert 2 * 4 * cost_zamba2.state_elements(SPEC, 32) == pytest.approx(
        9.51e9, rel=1e-3)
    flops = cost_zamba2.serve_call_flops(SPEC, 32, 512, 64)
    assert 3.5e14 < flops < 4.5e14


def zamba2_log(calls, layers, shared, n_new, device=True):
    """`calls` serve.generate spans: `layers` ssm.scan spans of 2 ms and
    `shared` zamba2.shared spans of 3 ms in the prefill, then n_new
    replays of 20 + c ms."""
    log = Log()
    for c in range(calls):
        t = 10.0 * c
        root = log.add("serve.generate", None, (t, t + 3.0),
                       (0.0, 3000.0) if device else None)
        log.add("serve.prefill", root, (t, t + 0.5),
                (0.0, 500.0) if device else None)
        for _ in range(shared):
            log.add("zamba2.shared", root, (t, t + 0.01),
                    (1.0, 4.0) if device else None)
        for _ in range(layers):
            log.add("ssm.scan", root, (t, t + 0.01),
                    (5.0, 7.0) if device else None)
        at = 600.0
        for _ in range(n_new):
            log.add("serve.replay", root, (t, t + 0.001),
                    (at, at + 20.0 + c) if device else None)
            at += 21.0 + c
    return log.spans


REC = {"job": "serve", "model": "zamba2", "profile_calls": 2, "n_new": 4,
       "mamba_layers": 5, "shared_calls": 2, "spec": SPEC, "batch": 32,
       "prompt": 512, "call_s": [6.0, 8.0], "prefill_s": [1.0, 1.0]}


def test_span_readers(program):
    program(zamba2_log(3, 5, 2, 4))
    assert read("ssd_scan_ms.serve", REC) == pytest.approx(5 * 2.0)
    assert read("shared_block_ms.serve", REC) == pytest.approx(2 * 3.0)
    step_s = (20 + 21) / 2 / 1e3
    want = 100 * cost_zamba2.decode_step_bytes(SPEC, 32, 512 + 2.5) / (
        cost.HW["hbm_bw"] * step_s)
    assert read("decode_roofline.hybrid.serve", REC) == pytest.approx(want)
    assert read("mfu.hybrid.serve", REC) == pytest.approx(
        100 * cost_zamba2.serve_call_flops(SPEC, 32, 512, 4)
        / (7.0 * cost.HW["peak_flops_bf16"]))


@pytest.mark.parametrize("metric", ["ssd_scan_ms.serve",
                                    "shared_block_ms.serve",
                                    "decode_roofline.hybrid.serve"])
def test_span_readers_find_nothing(program, metric):
    """Another model's record, spans of another count, spans off CUDA and
    a program without `profiled` read None."""
    program(zamba2_log(3, 5, 2, 4))
    assert read(metric, dict(REC, model=None)) is None
    program(zamba2_log(3, 4, 1, 3))
    assert read(metric, REC) is None
    program(zamba2_log(3, 5, 2, 4, device=False))
    assert read(metric, REC) is None
    program(None)
    assert read(metric, REC) is None


def test_flash_roofline_reader():
    """One hd-224 launch a shared-block call of each profiled call; the
    bytes set each launch's bound at the cell's shape."""
    one, what = cost.bound_s(*cost.flash_work(32, 32, 32, 512, 224, 2),
                             cost.HW["peak_flops_bf16"])
    assert what == "bytes"
    name = "void (anonymous namespace)::wg::flash_wgmma_kernel<224>(...)"
    rec = dict(REC, profile={"kernels": [[name, 4, 4 * 2 * one]]})
    assert read("roofline.flash_attention.serve", rec) == pytest.approx(50)
    rec["profile"] = {"kernels": [[name, 3, 1e-3]]}
    assert read("roofline.flash_attention.serve", rec) is None


def _tiny(seed=5):
    cj = harness.load_json("configs", "zamba2-7b-instruct")
    cfg = dict(cj, num_hidden_layers=5, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               attention_head_dim=32, intermediate_size=96, vocab_size=97,
               mamba_d_state=8, n_mamba_heads=2, hybrid_layer_ids=[0, 2, 3],
               adapter_rank=4, torch_dtype="float32")
    cell = copy.deepcopy(harness.load_json("workloads", CELL))
    cell["traffic"] = {"batch": 3, "prompt": 140, "new_tokens": 5,
                       "max_len": 160, "zipf": 1.0}
    return helpers.ctx(cell, cfg, seed=seed)


def test_job_agrees_with_the_reference():
    """fp32 at a tiny size with a ragged prompt (a chunk of 128 and 12):
    every served token is the reference's argmax."""
    ctx = _tiny()
    out = execute(ctx, helpers.e2e_entries(), [])
    assert out["correct"], out["checks"]
    assert all(row["value"] == 0.0 for row in out["checks"].values())
    assert out["attempted"] % 3 == 0 and out["failed"] == 0


@pytest.mark.parametrize("seed", [7, 8])
def test_zero_state_decode_is_caught(seed):
    """The decode from a zeroed state (`carry_prompt_state` off) reads over
    both of the cell's limits at a tiny size, four times over. (The fp8
    control and the altered token are judged at the cell's size on the
    card, `control_state.py`: at this size their gaps are the limits'.)"""
    job = harness.load_module("jobs", "serve_zamba2").make(_tiny(seed))
    out = control_state.readings(job, True, 0.0)    # one window call
    assert out["program"]["gap_mean"] == 0.0
    for k, lim in job.ctx.cell["limits"].items():
        assert out["fault_zero_state"][k] > 4 * lim, out["fault_zero_state"]


def test_traced_prefill_is_read_from_the_call_itself():
    """The traced run reads each span call's prefill from that call's own
    `serve.prefill` span (host clock off CUDA): one a call, shorter than
    the call, and the decode readers take the same calls."""
    job = harness.load_module("jobs", "serve_zamba2").make(_tiny())
    job.setup()
    rec = job.traced(2, 1)["record"]
    job.free()
    assert len(rec["prefill_s"]) == len(rec["call_s"]) == 2
    assert all(0 < p < c for p, c in zip(rec["prefill_s"], rec["call_s"]))
    pre = read("prefill_ms.serve", rec)
    assert pre == pytest.approx(500 * sum(rec["prefill_s"]))
    assert read("decode_ms.serve", rec) == pytest.approx(1e3 * sum(
        (c - p) / 5 for c, p in zip(rec["call_s"], rec["prefill_s"])) / 2)
