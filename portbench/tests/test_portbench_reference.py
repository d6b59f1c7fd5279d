"""The plain reference against the program's CPU path at smoke sizes (fp32
weights): one training step of each family and a served call, each driven
through the benchmark's own job, set-up, window and judgement; and the
reference's pieces where the program states the same arithmetic."""
from __future__ import annotations

import pytest
import torch

from portbench import harness, weights
from portbench.reference import model as M
from portbench.run import execute
from portbench.tests import helpers


@pytest.mark.parametrize("cell", ["qwen2vl-train-b4s2048",
                                  "qwen3moe-l4-train-b4s2048"])
def test_train_step_agrees(cell):
    c, cfg = helpers.tiny_cell(cell)
    out = execute(helpers.ctx(c, cfg), helpers.e2e_entries(), [])
    assert out["correct"], out["checks"]
    for name, row in out["checks"].items():
        assert row["value"] < 1e-4, (name, row)
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_generate_agrees():
    c, cfg = helpers.tiny_cell("qwen3moe-serve-b32")
    out = execute(helpers.ctx(c, cfg), helpers.e2e_entries(), [])
    assert out["correct"], out["checks"]
    for row in out["checks"].values():
        assert row["value"] == 0.0, out["checks"]
    assert out["attempted"] % c["traffic"]["batch"] == 0


def test_vlm_prefill_agrees():
    """M-RoPE over an image's patch embeddings: the program's prefill logits
    at the prompt's last position against the reference's forward."""
    from repro_torch.models.api import prefill
    from portbench.traffic import Traffic
    cfg = helpers.tiny_vlm()
    spec = M.from_config(cfg)
    params = weights.program_tree(spec, 3, "model", "cpu")
    tr = Traffic({"batch": 2, "prompt": 12, "image": [1, 2, 2],
                  "zipf": 1.0}, spec, 3, "cpu", params["io"]["embed"])
    batch = tr.prompts(0)
    got, _ = prefill(params, harness.program_config(spec, "t"), batch)
    io = M.upcast(weights.make_group(spec, 3, "model", "io", "cpu"))

    def layer(l):
        return M.upcast(weights.make_group(spec, 3, "model", f"layer{l}",
                                           "cpu"))
    want = M.forward_logits(spec, layer, io, batch, batch["positions"])
    torch.testing.assert_close(got[:, -1], want[:, -1], atol=1e-4,
                               rtol=1e-4)


def test_moe_groups_drop_as_the_program_does():
    """Capacity: one group of n tokens and the same tokens in one group
    a row drop different pairs, as the program's dispatch groups do."""
    from repro_torch.models.moe import apply_moe
    cfg = helpers.tiny_moe()
    spec = M.from_config(cfg)
    g = weights.make_group(spec, 9, "model", "layer0", "cpu")
    w = M.upcast(g)
    x = torch.randn(6, 64, generator=torch.Generator().manual_seed(1))
    x = x.repeat(4, 1)            # repeated tokens overfill their experts
    prog = {"router": g["router"], "w_up": g["e_up"], "w_gate": g["e_gate"],
            "w_down": g["e_down"]}
    want, aux = apply_moe(prog, harness.program_config(spec, "t"),
                          x[None])
    got, lb, z = M.moe(w, x, spec, None, "fp32")
    torch.testing.assert_close(got, want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lb, aux["lb_loss"], atol=1e-6, rtol=1e-6)
    assert float(aux["dropped_frac"]) > 0
