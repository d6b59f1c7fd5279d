"""The judgement bites: a run of each cell's job (the look for a card
skipped, tiny sizes, the cells' own limits) with the timed path broken
underneath comes out not correct, once for each fault the cell can have;
and the control, the reference in float8 in the program's place, reads far
above the program at a size a test run holds (on the card, at the cells'
sizes, `portbench/control.py` reads it; PERF.md keeps those readings)."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.run import execute
from portbench.tests import helpers

TRAIN = ["qwen2vl-train-b4s2048", "qwen3moe-l4-train-b4s2048"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    import repro_torch.train.step as step_mod
    real = step_mod.adamw

    def frozen(*a, **k):
        opt = real(*a, **k)
        return opt._replace(update_=lambda *args, **kw: None)
    monkeypatch.setattr(step_mod, "adamw", frozen)
    c, cfg = helpers.tiny_cell(cell)
    out = execute(helpers.ctx(c, cfg), helpers.e2e_entries(), [])
    assert not out["correct"]
    assert out["checks"]["change_leaf"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_caught(cell, monkeypatch):
    import repro_torch.train.step as step_mod
    real = step_mod.loss_and_grads

    def half(params, cfg_l, cfg_t, tcfg, batch):
        B = batch["labels"].shape[0] // 2
        batch = {k: (v[:, :B] if k == "positions" else v[:B])
                 for k, v in batch.items()}
        return real(params, cfg_l, cfg_t, tcfg, batch)
    monkeypatch.setattr(step_mod, "loss_and_grads", half)
    c, cfg = helpers.tiny_cell(cell)
    out = execute(helpers.ctx(c, cfg), helpers.e2e_entries(), [])
    assert not out["correct"], out["checks"]


def test_altered_token_is_caught(monkeypatch):
    from repro_torch.serve import engine as engine_mod
    real = engine_mod.ServeEngine.generate

    def altered(self, batch, n_new=16, return_logits=False):
        toks = real(self, batch, n_new, return_logits)
        toks[0, 2] = (toks[0, 2] + 101) % self.cfg.vocab_size
        return toks
    monkeypatch.setattr(engine_mod.ServeEngine, "generate", altered)
    c, cfg = helpers.tiny_cell("qwen3moe-serve-b32")
    out = execute(helpers.ctx(c, cfg), helpers.e2e_entries(), [])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_control_reads_far_above_the_program_train(cell):
    c, cfg = helpers.tiny_cell(cell, "bfloat16")
    ctx = helpers.ctx(c, cfg)
    job = harness.load_module("jobs", "train").make(ctx)
    job.setup()
    prog = job.readings()
    job.free()
    ref = job.reference()
    mine = job.numbers(prog, ref)
    low = job.numbers(job.reference("fp8"), ref)
    assert low["terms1_rel"] > 3 * mine["terms1_rel"], (mine, low)
    assert any(low[k] > c["limits"][k] for k in c["limits"]), low


def test_control_reads_far_above_the_program_serve():
    c, cfg = helpers.tiny_cell("qwen3moe-serve-b32", "bfloat16")
    c["traffic"]["batch"] = 8
    ctx = helpers.ctx(c, cfg)
    job = harness.load_module("jobs", "serve").make(ctx)
    job.setup()
    job.window(0.1)
    job.free()
    call = job.sample()
    ref = job.reference(call)
    mine = job.numbers(ref, job.served(call))
    low = job.numbers(ref, job.reference(call, "fp8").argmax(-1))
    assert low["gap_mean"] > 3 * mine["gap_mean"], (mine, low)
    assert any(low[k] > c["limits"][k] for k in c["limits"]), low
