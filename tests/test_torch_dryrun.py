"""The port's dry run (launch/dryrun.py) and what it reads, on the CPU: the
kernels' meta path and their shared cost formulas (kernels/cost.py), the
collective counters (launch/hlo_analysis.py) and the scan formulas
(launch/roofline_fixup.py).

On smoke cuts of a dense (llama3.2-3b), a MoE (mixtral-8x7b), an SSM
(xlstm-1.3b) and the hybrid (zamba2-7b) config, in train, prefill and
decode:

* the kernel calls the dry run counts on meta tensors equal the calls of
  the `kernels/ops.py` entry points when the same step runs on the CPU
  (forward kernels), and each backward kernel is called once per forward
  call that autograd recorded (remat off);
* the attention, SSD, mLSTM and sLSTM forward FLOPs equal
  `roofline_fixup`'s formulas by the stated relation: SSD and sLSTM
  exactly; attention times visible_pairs / (S kv_per_q), within 1 / S
  relative (causal) or (w - 1) / (2 S) (window w); the mLSTM formula less
  2 B Lc H Pk (P - 1) a chunk exactly;
* a flash call on meta counts the formula's FLOPs, not the plain version's
  S x S;
* the kernels on CPU tensors still take the plain path, bitwise;
* the depth extrapolation equals a full-depth count exactly for tail-free
  stacks, and is within tail / unit of one unit's cost for zamba2's.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import cost, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch import roofline_fixup as rf  # noqa: E402
from repro_torch.launch.sharding import MeshShape  # noqa: E402
from repro_torch.models import api, ssm  # noqa: E402
from repro_torch.train.step import (make_hapfl_train_step,  # noqa: E402
                                    make_train_state)

ARCHS = ("llama3.2-3b", "mixtral-8x7b", "xlstm-1.3b", "zamba2-7b")
MODES = ("train", "prefill", "decode")
B, S = 2, 64
FORWARD = {"_rms": "rmsnorm", "_add_rms": "add_rmsnorm",
           "_flash": "flash_attention", "_kd_grad": "kd_loss_grad",
           "_kd": "kd_loss_fwd", "_decode_attn": "decode_attention"}
BACKWARD = {"rmsnorm": "rmsnorm_bwd", "add_rmsnorm": "add_rmsnorm_bwd",
            "flash_attention": "flash_attention_bwd"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cut(arch, remat=False):
    return dataclasses.replace(get_config(arch).smoke(), remat=remat)


def _cpu_calls(cfg, mode, monkeypatch):
    """{kernel: calls of its ops.py entry point} of one step of `cfg` on
    CPU tensors."""
    calls = {}
    for attr, name in FORWARD.items():
        def counted(*a, _fn=getattr(ops, attr), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, attr, counted)
    gen = torch.Generator().manual_seed(0)
    if mode == "train":
        state = make_train_state(gen, cfg, cfg.lite(), device="cpu")
        batch = api.dummy_batch(cfg, B, S, gen, device="cpu")
        make_hapfl_train_step(cfg, cfg.lite())(state, batch)
    else:
        params = api.init_model(gen, cfg, device="cpu")
        with torch.no_grad():
            if mode == "prefill":
                api.prefill(params, cfg, api.dummy_batch(
                    cfg, B, S, gen, with_labels=False, device="cpu"))
            else:
                cache = api.make_decode_cache(cfg, B, S, device="cpu")
                api.decode_step(params, cfg, api.dummy_batch(
                    cfg, B, 1, gen, with_labels=False, device="cpu"),
                    cache, 5)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("mode,remat", [("train", False), ("train", True),
                                        ("prefill", False),
                                        ("decode", False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_calls_equal_the_cpu_steps_entry_point_calls(
        arch, mode, remat, monkeypatch):
    """remat acts only where autograd records: in train."""
    cfg = _cut(arch, remat)
    counted = dryrun.count_step(cfg, ShapeConfig("t", S, B, mode))
    calls = {k: v["calls"] for k, v in counted["kernels"].items()}
    cpu = _cpu_calls(cfg, mode, monkeypatch)
    assert {k: calls.get(k, 0) for k in FORWARD.values()} == \
        {k: cpu.get(k, 0) for k in FORWARD.values()}
    assert sum(cpu.values()) > 0 or arch == "xlstm-1.3b"
    for fwd, bwd in BACKWARD.items():
        if mode != "train":
            assert calls.get(bwd, 0) == 0
        elif not remat:
            assert calls.get(bwd, 0) == cpu.get(fwd, 0), bwd
    assert not any(rms.launches.values())
    assert not any(flash.launches.values())
    assert not any(kd.launches.values())


def _attention_relation(cfg, S_):
    """The flash kernel's counted pairs over the formula's, per head."""
    w = cfg.sliding_window
    kv = min(w, S_) if w else S_ / 2
    return cost.visible_pairs(S_, True, w) / (S_ * kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_mechanism_flops_match_roofline_formulas(arch):
    """Prefill at B x 256 positions, all layers, forward."""
    cfg = _cut(arch)
    S_ = 256
    counted = dryrun.count_step(cfg, ShapeConfig("p", S_, B, "prefill"))
    mech = counted["mechanisms"]
    formula = rf.scan_flops(cfg, B, S_)
    assert mech["ssd"] == formula["ssd"]
    assert mech["slstm"] == formula["slstm"]
    d, inner, H, P, Pk = ssm.mlstm_dims(cfg)
    if formula["mlstm"]:
        Lc = min(rf.SSM_CHUNK, S_)
        n_mlstm = formula["mlstm"] / (2 * B * (Lc * Lc * H * (Pk + P) + 3 * Lc
                                               * H * Pk * P) * (S_ // Lc))
        assert mech["mlstm"] == formula["mlstm"] - (
            2 * B * Lc * H * Pk * (P - 1) * (S_ // Lc) * n_mlstm)
    else:
        assert mech["mlstm"] == 0
    assert mech["attention"] == pytest.approx(
        formula["attention"] * _attention_relation(cfg, S_), rel=1e-12)
    w = cfg.sliding_window
    tol = (w - 1) / (2 * S_) if w else 1 / S_
    assert mech["attention"] == pytest.approx(formula["attention"],
                                              rel=tol * 1.0001)
    assert any(mech.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scan_formulas_equal_the_references(arch):
    """The port's four formulas on its configs equal the reference's on the
    reference's configs, exactly: full width, the long-context variant and
    the smoke cut, at every INPUT_SHAPES entry's batch and length."""
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import roofline_fixup as ref_rf
    assert rf.SSM_CHUNK == ref_rf.SSM_CHUNK
    pairs = [(get_config(arch), ref_config(arch)),
             (get_config(arch).smoke(), ref_config(arch).smoke())]
    if not get_config(arch).subquadratic:
        pairs.append((get_config(arch).long_ctx_variant(),
                      ref_config(arch).long_ctx_variant()))
    for shape in REF_SHAPES.values():
        B_, S_ = shape.global_batch, shape.seq_len
        for port_cfg, ref_cfg in pairs:
            for fn in ("_attention_scores_flops", "_ssd_flops",
                       "_mlstm_flops", "_slstm_flops"):
                assert getattr(rf, fn)(port_cfg, B_, S_) == \
                    getattr(ref_rf, fn)(ref_cfg, B_, S_), (fn, shape.name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_flops_against_xla_cost_analysis(arch):
    """The dry run's prefill count at the smoke cut, B x 256 positions,
    against XLA's `cost_analysis()` of the reference's compiled prefill on
    the CPU (layers unrolled, one attention query chunk). The port's count
    is first put in the reference's terms: its attention takes every
    (query, key) pair, masked after the products, where the flash kernel
    takes the visible pairs; it unembeds every position, where the port
    unembeds the last; the SSD / mLSTM chunk scans and the sLSTM time scan,
    which XLA counts once, get the reference's own fixup. XLA then counts
    0 to 3% more, its elementwise FLOPs (norms, softmax, gates, RoPE),
    which `flop_counter` does not count (0.5-2.7% measured, all 10
    configs)."""
    import jax
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import roofline_fixup as ref_rf
    from repro.launch.specs import input_specs as ref_specs
    from repro.models.api import prefill as ref_prefill
    S_ = 256
    assert S_ <= ref_rf.Q_CHUNK
    rc = ref_config(arch).smoke()
    assert not rc.scan_layers
    specs = ref_specs(rc, RefShape("p", S_, B, "prefill"), rc.lite())
    compiled = jax.jit(lambda p, b: ref_prefill(p, rc, b)).lower(
        specs["params"], specs["batch"]).compile()
    xla = compiled.cost_analysis()
    xla = (xla[0] if isinstance(xla, list) else xla)["flops"]
    nc = max(S_ // ref_rf.SSM_CHUNK, 1)
    xla += ((ref_rf._ssd_flops(rc, B, S_) + ref_rf._mlstm_flops(rc, B, S_))
            * (1 - 1 / nc) + ref_rf._slstm_flops(rc, B, S_) * (1 - 1 / S_))

    cfg = _cut(arch)
    counted = dryrun.count_step(cfg, ShapeConfig("p", S_, B, "prefill"))
    flash_ = counted["kernels"].get("flash_attention",
                                    {"calls": 0, "flops": 0})
    every_pair = (flash_["calls"] * 4 * B * cfg.n_heads * S_ * S_
                  * cfg.resolved_head_dim)
    every_row = (2 * B * (S_ - 1) * cfg.d_model * cfg.vocab_size
                 * max(cfg.n_codebooks, 1))
    port = counted["flops"] - flash_["flops"] + every_pair + every_row
    assert 0 <= xla - port <= 0.03 * xla, (xla, port)


def test_flash_on_meta_counts_the_formula_not_the_plain_scores():
    Bq, H, KV, S_, hd = 2, 4, 2, 512, 64
    q = torch.empty((Bq, H, S_, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((Bq, KV, S_, hd), dtype=torch.bfloat16, device="meta")
    counter = dryrun._Counter()
    with cost.counting() as tally, counter:
        o = ops.flash_attention_op(q, k, k)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    assert counter.flops == 0
    want = cost.flash_work(Bq, H, KV, S_, hd, 0, 2)
    assert tally["flash_attention"] == {"calls": 1, "bytes": want[0],
                                        "flops": want[1]}
    assert want[1] == 4 * hd * Bq * H * S_ * (S_ + 1) // 2
    with FlopCounterMode(display=False) as fc:
        ref.flash_attention_ref(q, k, k)
    assert fc.get_total_flops() == 4 * Bq * H * S_ * S_ * hd
    assert fc.get_total_flops() != want[1]
    assert not any(flash.launches.values())


def test_kernels_on_cpu_tensors_take_the_plain_path_bitwise():
    g = torch.Generator().manual_seed(3)
    x, dlt = (torch.randn(16, 64, generator=g) for _ in range(2))
    scale = torch.randn(64, generator=g)
    assert torch.equal(rms.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale, 1e-5))
    for a, b in zip(rms.add_rmsnorm(x, dlt, scale),
                    ref.add_rmsnorm_ref(x, dlt, scale, 1e-5)):
        assert torch.equal(a, b)
    q = torch.randn(2, 4, 32, 16, generator=g)
    kv = torch.randn(2, 2, 32, 16, generator=g)
    assert torch.equal(flash.flash_attention(q, kv, kv, sliding_window=8),
                       ref.flash_attention_ref(q, kv, kv, causal=True,
                                               sliding_window=8))
    xl, yl = (torch.randn(2, 8, 40, generator=g) for _ in range(2))
    lab = torch.randint(0, 40, (2, 8), generator=g)
    lam = (0.4, 0.6, 0.5, 0.5)
    for a, b in zip(kd.kd_loss_grad(xl, yl, lab, lam),
                    ref.kd_loss_grad_ref(xl, yl, lab, lam)):
        assert torch.equal(a, b)
    assert not any(rms.launches.values())
    assert not any(flash.launches.values())
    assert not any(kd.launches.values())


def test_meta_norm_and_kd_calls_record_their_formulas():
    x = torch.empty((128, 256), dtype=torch.bfloat16, device="meta")
    sc = torch.empty((256,), dtype=torch.bfloat16, device="meta")
    logits = torch.empty((1, 64, 1000), dtype=torch.float32, device="meta")
    lab = torch.empty((1, 64), dtype=torch.int64, device="meta")
    with cost.counting() as tally:
        y = ops.rmsnorm_op(x, sc)
        s, y2 = ops.add_rmsnorm_op(x, x, sc)
        dx, dy, means = ops.kd_loss_grad_op(logits, logits, lab,
                                            (0.4, 0.6, 0.5, 0.5))
    assert y.shape == x.shape and s.shape == y2.shape == x.shape
    assert dx.shape == logits.shape and means.shape == (6, 1)
    assert tally["rmsnorm"]["flops"] == cost.norm_work(128, 256, 2)[1]
    assert tally["add_rmsnorm"]["bytes"] == cost.add_norm_work(128, 256, 2)[0]
    assert tally["kd_loss_grad"] == {"calls": 1,
                                     "bytes": cost.grad_work(1, 64, 1000,
                                                             4)[0],
                                     "flops": cost.grad_work(1, 64, 1000,
                                                             4)[1]}
    # outside counting() a meta call records nothing and still returns
    assert ops.rmsnorm_op(x, sc).is_meta


@pytest.mark.parametrize("arch,cut,exact", [
    ("llama3.2-3b", {"n_layers": 5}, True),
    ("xlstm-1.3b", {"n_layers": 6, "slstm_every": 2}, True),
    ("zamba2-7b", {"n_layers": 5, "shared_attn_every": 2}, False),
])
@pytest.mark.parametrize("mode", MODES)
def test_extrapolated_count_against_full_depth(arch, cut, exact, mode):
    cfg = dataclasses.replace(_cut(arch, remat=True), **cut)
    shape = ShapeConfig("t", S, B, mode)
    full = dryrun.count_step(cfg, shape)
    extra = dryrun.scan_corrected_cost(cfg, shape)
    u, n_units, tail = dryrun._unit_layout(cfg)
    assert (tail == 0) == exact
    if exact:
        for k in ("flops", "bytes", "kernels", "mechanisms"):
            assert extra[k] == full[k], k
        return
    # the tail of `tail` Mamba2 layers is taken as tail / u of a unit
    for k in ("flops", "bytes"):
        bound = extra[f"{k}_per_unit"] * tail / u
        assert abs(extra[k] - full[k]) <= bound, k
        assert extra[k] != full[k]


def test_microbatched_train_step_counts_one_microbatch_times_n():
    cfg = _cut("llama3.2-3b")
    shape = ShapeConfig("t", S, 4 * B, "train")
    from repro_torch.train.step import TrainStepConfig
    mb = dryrun.scan_corrected_cost(cfg, shape, TrainStepConfig(microbatch=4))
    one = dryrun.count_step(cfg, ShapeConfig("t", S, B, "train"))
    assert mb["flops"] == 4 * one["flops"]
    assert mb["kernels"]["kd_loss_grad"]["calls"] == 4
    real = dryrun.count_step(cfg, shape, tcfg=TrainStepConfig(microbatch=4))
    assert {k: v["calls"] for k, v in real["kernels"].items()} == \
        {k: v["calls"] for k, v in mb["kernels"].items()}


def test_aten_flops_equal_flop_counter_mode():
    cfg = _cut("mixtral-8x7b", remat=True)
    with FlopCounterMode(display=False) as fc:
        counted = dryrun.count_step(cfg, ShapeConfig("t", S, B, "train"))
    assert counted["aten_flops"] == fc.get_total_flops() > 0
    assert counted["flops"] == counted["aten_flops"] + sum(
        v["flops"] for v in counted["kernels"].values())


def test_visible_pairs_closed_form_equals_the_loop():
    def loop(S_, causal, window):
        total = 0
        for i in range(S_):
            hi = i + 1 if causal else S_
            lo = max(0, i - window + 1) if window else 0
            total += hi - lo
        return total
    for S_ in (1, 2, 7, 64, 100, 513):
        for window in (0, 1, 3, 64, 600):
            for causal in (True, False):
                assert cost.visible_pairs(S_, causal, window) == \
                    loop(S_, causal, window), (S_, window, causal)


def test_collective_stats_helpers():
    assert hlo_analysis.shape_bytes((2, 4096), torch.bfloat16) == 16384
    stats = {"all-gather": {"count": 1, "bytes": 16384},
             "all-reduce": {"count": 2, "bytes": 512}}
    assert hlo_analysis.total_collective_bytes(stats) == 16896
    counted = dryrun.count_step(_cut("llama3.2-3b"),
                                ShapeConfig("p", S, B, "prefill"))
    n_mm = hlo_analysis.count_op(counted["ops"], "mm")
    assert n_mm == sum(n for op, n in counted["ops"].items()
                       if op.startswith("mm."))
    assert n_mm > 0
    with hlo_analysis.collective_stats() as outer:
        from repro_torch.launch import mesh
        mesh._record("all-gather", 10)
        with hlo_analysis.collective_stats() as inner:
            mesh._record("all-reduce", 4)
    assert outer == {"all-gather": {"count": 1, "bytes": 10},
                     "all-reduce": {"count": 1, "bytes": 4}}
    assert inner == {"all-reduce": {"count": 1, "bytes": 4}}
    assert mesh._STATS == []


def test_inner_scan_fixup_adds_nothing():
    art = {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
           "dominant": "memory_s", "shape": "train_4k"}
    out = rf.inner_scan_fixup(art)
    assert out["compute_s_fixed"] == 1.0 and out["memory_s_fixed"] == 2.0
    assert out["collective_s_fixed"] == 0.5
    assert out["dominant_fixed"] == "memory_s"
    assert out["inner_scan_extra_flops_per_chip"] == 0.0


def test_run_one_mixtral_at_full_width_on_the_node_mesh():
    res = dryrun.run_one("mixtral-8x7b", "decode_32k")
    cfg = get_config("mixtral-8x7b")
    assert res["n_chips"] == 8 and res["mesh"] == "1x8(data,model)"
    assert res["kernels"]["rmsnorm"]["calls"] == 1
    assert res["kernels"]["add_rmsnorm"]["calls"] == 2 * cfg.n_layers
    mem = res["memory"]
    # bf16 weights (93.4 GB) and the decode cache, split over 8 cards
    assert mem["argument_size_total"] > 2 * cfg.num_params()
    assert mem["argument_size_total"] / 8 <= mem["argument_size_in_bytes"] \
        < mem["argument_size_total"]
    assert res["hlo_flops_per_chip"] == res["flops_total"] / 8
    assert res["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert res["collectives"]["all-gather"]["count"] > 0
    assert "reduce-scatter" not in res["collectives"]


def test_cli_writes_an_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--tag", "t"])
    (path,) = tmp_path.glob("*.json")
    art = json.loads(path.read_text())
    assert art["arch"] == "olmo-1b" and art["shape"] == "decode_32k"
    assert art["compute_s"] > 0 and art["memory_s"] > 0


def test_one_card_mesh_has_no_collectives():
    one = MeshShape((1, 1), ("data", "model"))
    res = dryrun.dry_run(_cut("llama3.2-3b"), ShapeConfig("t", S, B,
                                                          "train"), one,
                         probes=False)
    assert res["collectives"] == {} and res["collective_s"] == 0
    assert res["memory"]["argument_size_in_bytes"] == \
        res["memory"]["argument_size_total"]
