"""The yardstick's arithmetic on hand-worked shapes: the frozen kernel and
model formulas, the idle share and gap labels of a synthetic timeline, the
95th percentile over all requests, and the per-layer readers on synthetic
records."""
from __future__ import annotations

import pytest

from portbench import cost, harness
from portbench.reference.model import Spec

TINY = Spec(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, ff=16, vocab=10)
TINY_MOE = Spec(layers=1, d=8, heads=2, kv_heads=1, head_dim=4, ff=0,
                vocab=10, experts=4, top_k=2, moe_ff=6)


def test_visible_pairs():
    assert cost.visible_pairs(4) == 10          # 1 + 2 + 3 + 4
    assert cost.visible_pairs(4, causal=False) == 16
    assert cost.visible_pairs(5, True, 2) == 3 + 3 * 2


def test_kernel_work_by_hand():
    # kd_loss_grad: 4 tensors of N V fp32, labels, the (6, C) means
    assert cost.grad_work(1, 8192, 151936, 4) == (
        4 * 8192 * 151936 * 4 + 4 * 8192 + 24, 28 * 8192 * 151936)
    # flash: (B, H, KV, S, hd) = (1, 2, 1, 4, 8) bf16
    assert cost.flash_work(1, 2, 1, 4, 8, 2) == ((4 + 2) * 4 * 8 * 2,
                                                  4 * 8 * 2 * 10)
    assert cost.flash_bwd_work(1, 2, 1, 4, 8, 2) == (
        (8 + 4) * 4 * 8 * 2 + 4 * 2 * 4, 10 * 8 * 2 * 10)
    t, by = cost.bound_s(3.35e12, 1.0, 1e12)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = cost.bound_s(1.0, 2e12, 1e12)
    assert t == pytest.approx(2.0) and by == "operations"


def test_model_flops_by_hand():
    # a dense block: attention 8*8 + 2*8*4 + 8*8 = 192, mlp 3*8*16 = 384,
    # norms 16; two blocks and the final norm: 2 * 592 + 8; head 80
    assert cost.active_params(TINY) == (1192, 80)
    # MoE: attention 192, norms 16, router 32, 2 of 4 experts of 3*8*6
    assert cost.active_params(TINY_MOE) == (192 + 16 + 32 + 2 * 144 + 8, 80)
    # training: 6 N tokens + 3 x causal attention (4 hd B H pairs a layer)
    B, S = 2, 4
    attn = 2 * 4 * 4 * B * 2 * 10
    assert cost.train_step_flops([TINY], B, S) == pytest.approx(
        6 * 1272 * B * S + 3 * attn)
    # serving: blocks for all B (P + n) tokens, head for 1 + n positions
    want = (2 * 1192 * 2 * (4 + 2) + 2 * 80 * 2 * 3
            + 2 * 4 * 4 * 2 * 2 * (10 + 5 + 6))
    assert cost.serve_call_flops(TINY, 2, 4, 2) == pytest.approx(want)


def test_decode_bytes_count_routed_experts_only():
    full = cost.decode_step_bytes(TINY_MOE, 2, 5, 4)
    half = cost.decode_step_bytes(TINY_MOE, 2, 5, 2)
    assert full - half == pytest.approx(2 * 144 * 2)
    # dense: weights bf16 once, router none, KV 2 B KV hd 2 bytes a slot
    kv = 2 * 2 * 1 * 4 * 2
    want = 2 * ((192 + 16 + 384) * 2 + kv * 5 + kv) + 8 * 2 + 80 * 2 \
        + 2 * 8 * 2
    assert cost.decode_step_bytes(TINY, 2, 5, 0) == pytest.approx(want)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert harness.union_length(iv) == pytest.approx(4.0)
    assert harness.idle_gaps(iv) == [(2.0, 3.0), (4.0, 6.0)]
    host = [(1.5, 3.2, "aten::mm"), (2.1, 2.9, "cudaLaunchKernel"),
            (3.9, 4.5, "aten::copy_")]
    labels = harness.label_gaps(harness.idle_gaps(iv), host)
    assert labels == [["host (no operation)", 2.0],
                      ["cudaLaunchKernel", 1.0]]


def test_idle_share_reader():
    mod = harness.load_module("metrics", "idle_share.train")
    rec = {"job": "train", "profile": {"wall_s": 2.0, "busy_s": 1.5}}
    assert mod.read(rec) == pytest.approx(25.0)


def test_p95_over_all_requests():
    # 10 calls of 32 requests each: every request carries its call's time,
    # so the 95th percentile of the 320 is the slowest call's
    lat = [1.0 + 0.1 * i for i in range(10)]
    per = [x for x in lat for _ in range(32)]
    assert harness.percentile(per, 95) == pytest.approx(1.9)
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile([3.0], 95) == 3.0


def test_flash_roofline_needs_the_expected_launches():
    mod = harness.load_module("metrics", "roofline.flash_attention.train")
    kernels = [("void flash_wgmma_kernel<1>", 8, 0.004),
               ("void flash_bwd_prep_kernel", 4, 0.001),
               ("void flash_bwd_dkdv_wgmma_kernel", 4, 0.004),
               ("void flash_bwd_dq_wgmma_kernel", 4, 0.003)]
    rec = {"job": "train", "profile": {"kernels": kernels},
           "profile_steps": 2, "specs": [TINY], "batch": 1, "seq": 4,
           "remat": True}
    share = mod.read(rec)
    f, _ = cost.bound_s(*cost.flash_work(1, 2, 1, 4, 4, 2), 989e12)
    b, _ = cost.bound_s(*cost.flash_bwd_work(1, 2, 1, 4, 4, 2), 989e12)
    assert share == pytest.approx(100 * 2 * 2 * (2 * f + b) / 0.012)
    rec["remat"] = False          # 8 forwards are not 4: nothing to read
    assert mod.read(rec) is None


def test_mfu_reader():
    mod = harness.load_module("metrics", "mfu.train")
    rec = {"job": "train", "step_s": [0.5, 1.5], "specs": [TINY],
           "batch": 2, "seq": 4}
    flops = cost.train_step_flops([TINY], 2, 4)
    assert mod.read(rec) == pytest.approx(100 * flops / 989e12)
