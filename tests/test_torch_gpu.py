"""On the card: the port's CUDA kernels against their plain versions, one
cohort trained through them against the same cohort on the CPU, the
serving path on the card against the CPU, the norm and flash backward
kernels against their plain versions (and the norm backward under a CUDA
graph against its eager launch), gradients and training steps on the
card against the CPU, the MoE layer against the CPU, the MoE, VLM,
audio and SSM decode steps graphed against their eager loops, and the SSM
family's prefill, decode, gradients and train step against the CPU. Every
test here is marked gpu and skips inside its fixture on a machine without CUDA.
The file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.fl import BatchedClientEngine, FLEnvironment, FLSimConfig
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels.ref import (flash_attention_ref, kd_loss_grad_ref,
                                     kd_loss_ref, rmsnorm_ref)
from repro_torch.models.api import (decode_step, forward, init_model,
                                    make_decode_cache, prefill)
from repro_torch.models.cnn import init_cnn
from repro_torch.serve import ServeEngine, make_decode_step
from repro_torch.utils.pytree import tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import close_kd_grad  # noqa: E402  (the card's limits)
from chip_smoke import (DECODE_GRAPHED, check_decode_attention,  # noqa: E402
                        check_decode_graph, decode_positions, decode_shapes)

TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the tolerances of tests/test_kernels.py
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# kd_loss_fwd / kd_loss_bwd gradients in bf16, which the kernel and the plain
# version both round from fp32: one bf16 ulp of each element, plus 2^-10 of
# the tensor's largest |value| (chip_smoke.py's KD_BF16_* limits)
KD_BF16_RTOL = 2.0 ** -7
KD_BF16_ATOL_SHARE = 2.0 ** -10
# rmsnorm and flash attention: fp32 looser than tests/test_kernels.py's
# 2e-6, which assumes the CPU's order of summation; bf16 as there
TOL_NORM = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
# flash at hd 112 (B, H, KV, S, hd, window, dtype): zamba2-7b's shared
# block at full width, a ragged S, a sliding window, a group of 4
HD112_CASES = [(B, H, KV, S, 112, w, dt)
               for B, H, KV, S, w in ((4, 32, 32, 512, 0), (2, 4, 4, 300, 0),
                                      (1, 4, 4, 256, 64), (2, 8, 2, 256, 0))
               for dt in ("bfloat16", "float32")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full float32 on both sides of every comparison: cuDNN convolutions
    # default to TF32, which keeps about three decimal digits
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _inputs(N, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, V)) * 3.0).astype(np.float32)
    y = (rng.standard_normal((N, V)) * 3.0).astype(np.float32)
    return x, y, rng.integers(0, V, N).astype(np.int32)


def _stopgrad_reference(x, y, lab, g):
    """Autograd of the plain version with the Eqs. 33-34 stop-gradients."""
    tx = kd_loss_ref(x, y.detach(), lab)
    ty = kd_loss_ref(x.detach(), y, lab)
    terms = (tx["ce_x"], ty["ce_y"], tx["kl_xy"], ty["kl_yx"])
    loss = sum((gi * t).sum() for gi, t in zip(g, terms))
    return torch.autograd.grad(loss, (x, y))


def _assert_kd_grad_close(got, exp):
    if got.dtype == torch.float32:
        atol = rtol = TOL["float32"]
    else:
        atol = KD_BF16_ATOL_SHARE * float(exp.float().abs().max())
        rtol = KD_BF16_RTOL
    torch.testing.assert_close(got.float(), exp.float(), atol=atol, rtol=rtol)


def _check_kd_kernels(xt, yt, labt, g):
    """KDLoss through the kernels (one forward and one backward launch)
    against the plain forward and its stop-gradient autograd: the terms,
    fp32, at the fp32 limit whatever the logits' dtype."""
    before = dict(tkd.launches)
    got = tkd.kd_loss(xt, yt, labt)
    loss = sum((gi * got[k]).sum() for gi, k in zip(g, TERMS))
    dx, dy = torch.autograd.grad(loss, (xt, yt))
    torch.cuda.synchronize()
    assert tkd.launches["kd_loss_fwd"] == before["kd_loss_fwd"] + 1
    assert tkd.launches["kd_loss_bwd"] == before["kd_loss_bwd"] + 1
    exp = kd_loss_ref(xt, yt, labt)
    for k in TERMS:
        torch.testing.assert_close(got[k], exp[k], atol=TOL["float32"],
                                   rtol=TOL["float32"])
    ex, ey = _stopgrad_reference(xt, yt, labt, g)
    _assert_kd_grad_close(dx, ex)
    _assert_kd_grad_close(dy, ey)


def _kd_tensors(N, V, dtype, device, seed=5):
    x, y, lab = _inputs(N, V, seed=seed)
    tdt = getattr(torch, dtype)
    g = np.random.default_rng(seed + 1).standard_normal((4, N))
    return (torch.from_numpy(x).to(device, tdt),
            torch.from_numpy(y).to(device, tdt),
            torch.from_numpy(lab).to(device),
            torch.from_numpy(g.astype(np.float32)).to(device))


# the HAPFL path's rows, a ragged N, a ragged V in both dtypes, the
# vocabulary shape in both dtypes, chip_smoke.py 13c's rank rows and a few
# such rows in bf16 and in fp32 (the forward's 8-block cluster)
@pytest.mark.gpu
@pytest.mark.parametrize("N,V,dtype", [(128, 10, "float32"),
                                       (256, 10, "float32"),
                                       (1000, 10, "float32"),
                                       (64, 777, "float32"),
                                       (64, 777, "bfloat16"),
                                       (2048, 32000, "float32"),
                                       (2048, 32000, "bfloat16"),
                                       (1024, 151936, "bfloat16"),
                                       (64, 151936, "bfloat16"),
                                       (64, 151936, "float32")])
def test_cuda_kernels_match_plain(cuda, N, V, dtype):
    x, y, lab, g = _kd_tensors(N, V, dtype, cuda)
    _check_kd_kernels(x.requires_grad_(True), y.requires_grad_(True), lab, g)


@pytest.mark.gpu
def test_cuda_kernels_on_an_unaligned_row_slice(cuda):
    """Rows 3:67 of a (70, 4099) bf16 tensor: the slice's base and every
    row's start lie off 16 bytes, so the kernels take their scalar loads."""
    x, y, lab, g = _kd_tensors(70, 4099, "bfloat16", cuda)
    xs = x.requires_grad_(True)[3:67]
    ys = y.requires_grad_(True)[3:67]
    assert xs.data_ptr() % 16 != 0
    _check_kd_kernels(xs, ys, lab[3:67], g[:, 3:67])


def _kd_launches(x, y, lab, g):
    terms, stats = tkd.kd_loss_fwd(x, y, lab)
    dx, dy = tkd.kd_loss_bwd(x, y, lab, stats, g.contiguous())
    return terms, stats, dx, dy


# (N, V, dtype, rows): the variants of the forward (a warp, a block and a
# cluster of blocks a row), vector and scalar loads
KD_BITWISE = [(256, 10, "float32", (128, 256)),
              (64, 777, "bfloat16", (3, 40)),
              (70, 4099, "bfloat16", (3, 67)),
              (2048, 32000, "float32", (5, 69)),
              (2048, 32000, "bfloat16", (1000, 1100)),
              (1024, 151936, "bfloat16", (512, 1024))]


@pytest.mark.gpu
@pytest.mark.parametrize("N,V,dtype", [case[:3] for case in KD_BITWISE])
def test_cuda_kd_kernels_two_launches_bitwise(cuda, N, V, dtype):
    x, y, lab, g = _kd_tensors(N, V, dtype, cuda, seed=7)
    first = _kd_launches(x, y, lab, g)
    second = _kd_launches(x, y, lab, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("N,V,dtype,rows", KD_BITWISE)
def test_cuda_kd_kernels_rows_independent_of_n(cuda, N, V, dtype, rows):
    """A row's terms, stats and gradients are the same bits whether it is
    computed in the N-row call or in a call on a slice of those rows."""
    a, b = rows
    x, y, lab, g = _kd_tensors(N, V, dtype, cuda, seed=8)
    terms, stats, dx, dy = _kd_launches(x, y, lab, g)
    part = _kd_launches(x[a:b], y[a:b], lab[a:b], g[:, a:b])
    for whole, got in zip((terms[:, a:b], stats[:, a:b], dx[a:b], dy[a:b]),
                          part):
        assert torch.equal(whole, got)


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_non_contiguous(cuda):
    x = torch.zeros((8, 20), device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        tkd.kd_loss_fwd(x, x, torch.zeros(8, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_cuda_cohort_matches_cpu(cuda):
    """A 2-size ragged cohort trained on the card (through the kernels)
    equals the same cohort on the CPU (through the plain versions). GEMMs
    sum in another order on the two devices, hence the tolerance."""
    cfg = FLSimConfig(dataset="mnist", n_train=400, n_test=100,
                      batches_per_epoch=1, default_epochs=2, n_clients=6,
                      k_per_round=4, size_names=("small", "large"))
    gen = torch.Generator().manual_seed(0)
    env0 = FLEnvironment(cfg)
    lite = init_cnn(gen, env0.lite_cfg, "cpu")
    globals_ = {s: init_cnn(gen, c, "cpu") for s, c in env0.pool.items()}
    cohort = ([0, 1, 2, 3], ["small", "small", "large", "large"],
              [1, 3, 2, 1])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        on = lambda t: tree_map(lambda a: a.to(dev), t)
        eng = BatchedClientEngine(FLEnvironment(cfg), device=dev)
        before = tkd.launches["kd_loss_grad"]
        out[dev.type] = eng.train_cohort(
            *cohort, {s: on(p) for s, p in globals_.items()}, on(lite))
        if dev.type == "cuda":
            assert tkd.launches["kd_loss_grad"] > before
    for a, b in zip(out["cuda"], out["cpu"]):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,dtype", [(2048, 3072, "bfloat16"),
                                       (4, 3072, "bfloat16"),
                                       (2048, 3072, "float32"),
                                       (1000, 3072, "float32"),
                                       (64, 777, "float32"),
                                       (64, 777, "bfloat16"),
                                       # zamba2-7b: prefill and training,
                                       # decode
                                       (2048, 3584, "bfloat16"),
                                       (4, 3584, "bfloat16"),
                                       (2048, 3584, "float32"),
                                       (4, 3584, "float32")])
def test_cuda_rmsnorm_matches_plain(cuda, N, d, dtype):
    rng = np.random.default_rng(N + d)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32)
                         ).to(cuda, tdt)
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(cuda, tdt)
    before = trms.launches["rmsnorm"]
    got = trms.rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert trms.launches["rmsnorm"] == before + 1
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, sc).float(),
                               atol=TOL_NORM[dtype], rtol=TOL_NORM[dtype])


def _flash_inputs(B, H, KV, S, hd, dtype, layout, device):
    """q (B, H, S, hd), k and v (B, KV, S, hd) from numpy: contiguous for
    layout "bhsd", the transposed views of (B, S, H, hd) tensors (what the
    model passes) for "bshd"."""
    rng = np.random.default_rng(S + hd)
    tdt = getattr(torch, dtype)
    out = []
    for n in (H, KV, KV):
        shape = (B, n, S, hd) if layout == "bhsd" else (B, S, n, hd)
        t = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, tdt)
        out.append(t if layout == "bhsd" else t.transpose(1, 2))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("N,d", [(2048, 3072), (1000, 3072), (2048, 256)])
@pytest.mark.parametrize("variant", ["rmsnorm", "add"])
def test_cuda_rmsnorm_bwd_graph_replay_is_eager_bitwise(cuda, N, d, variant):
    """The norm backward is one launch whose dscale reduction resets its
    counters: replayed from a CUDA graph, again and again, it gives the
    bits of an eager launch on the same inputs."""
    rng = np.random.default_rng(N + d)
    x, dy, gs = (torch.from_numpy(rng.standard_normal((N, d)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(3))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    if variant == "rmsnorm":
        run = lambda: trms.rmsnorm_bwd(x, sc, dy)
    else:
        run = lambda: trms.add_rmsnorm_bwd(x, sc, gs, dy)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("B,H,KV,S,hd,window,dtype", [
    (4, 24, 8, 512, 128, 0, "bfloat16"),
    (4, 24, 8, 512, 128, 0, "float32"),
    (2, 4, 2, 300, 128, 0, "float32"),
    (2, 4, 2, 300, 128, 0, "bfloat16"),
    (1, 4, 4, 256, 128, 64, "float32"),
    (1, 4, 4, 256, 128, 64, "bfloat16"),
    (2, 8, 2, 200, 64, 0, "bfloat16"),
    (1, 2, 2, 130, 64, 16, "float32"),
    (1, 2, 2, 130, 64, 16, "bfloat16"),
    # qwen2-vl-2b: 12 heads over 2 KV heads, a group of 6
    (4, 12, 2, 512, 128, 0, "bfloat16"),
    (4, 12, 2, 512, 128, 0, "float32"),
    # musicgen-medium: H = KV at hd 64
    (4, 24, 24, 512, 64, 0, "bfloat16"),
    (4, 24, 24, 512, 64, 0, "float32"),
    # zamba2-7b's shared block: H = KV = 32 at hd 112, run on hd 128's
    # tiles; a ragged S, a window and a group of 4 at hd 112
    *HD112_CASES])
def test_cuda_flash_attention_matches_plain(cuda, B, H, KV, S, hd, window,
                                            dtype, layout):
    """bf16 runs the wgmma kernel, fp32 the SIMT kernel; both read strided
    views where they lie and give the (B, H, S, hd) view of a (B, S, H, hd)
    tensor."""
    q, k, v = _flash_inputs(B, H, KV, S, hd, dtype, layout, cuda)
    before = tflash.launches["flash_attention"]
    got = tflash.flash_attention(q, k, v, causal=True, sliding_window=window)
    torch.cuda.synchronize()
    assert tflash.launches["flash_attention"] == before + 1
    exp = flash_attention_ref(q, k, v, causal=True, sliding_window=window)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), exp.float(),
                               atol=TOL_FLASH[dtype], rtol=TOL_FLASH[dtype])


# flash at hd 224 (B, H, KV, S, window): Zamba2-7B's shared blocks at the
# serve cell's prefill, a ragged S, a window and a group of 4; the scale is
# theirs, (hd / 2)^-0.5
HD224_CASES = [(32, 32, 32, 512, 0), (2, 4, 4, 300, 0), (1, 4, 4, 256, 64),
               (2, 8, 2, 256, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("B,H,KV,S,window", HD224_CASES)
def test_cuda_flash_attention_hd224_matches_plain(cuda, B, H, KV, S, window,
                                                  layout):
    """The bf16 forward at hd 224 runs on 256-wide tiles (TMA zero-fills
    columns 224..255 and clips them on the store) and takes the softmax
    scale as an argument."""
    q, k, v = _flash_inputs(B, H, KV, S, 224, "bfloat16", layout, cuda)
    scale = 112 ** -0.5
    before = tflash.launches["flash_attention"]
    got = tflash.flash_attention(q, k, v, causal=True, sliding_window=window,
                                 scale=scale)
    torch.cuda.synchronize()
    assert tflash.launches["flash_attention"] == before + 1
    exp = flash_attention_ref(q, k, v, causal=True, sliding_window=window,
                              scale=scale)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), exp.float(),
                               atol=TOL_FLASH["bfloat16"],
                               rtol=TOL_FLASH["bfloat16"])


@pytest.mark.gpu
def test_cuda_flash_attention_hd224_is_forward_only(cuda):
    """hd 224 has the bf16 forward alone: its backward, a forward that
    autograd records and the fp32 kernel raise ValueError."""
    q, k, v = _flash_inputs(1, 2, 2, 64, 224, "bfloat16", "bhsd", cuda)
    o, lse = q.clone(), torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        tflash.flash_attention_bwd(q, k, v, o, lse, o)
    with pytest.raises(ValueError, match="backward"):
        tflash.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(ValueError):
        f = [t.detach().float() for t in (q, k, v)]
        tflash.flash_attention(*f)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,dtype", [(64, "bfloat16"), (112, "bfloat16"),
                                      (128, "bfloat16"), (112, "float32"),
                                      (128, "float32")])
def test_cuda_flash_attention_default_scale_bitwise(cuda, hd, dtype):
    """The scale argument at 1/sqrt(hd) gives the bits of a call without
    it, at every head dim the kernels had before it."""
    q, k, v = _flash_inputs(2, 8, 4, 300, hd, dtype, "bshd", cuda)
    a = tflash.flash_attention(q, k, v)
    b = tflash.flash_attention(q, k, v, scale=1.0 / hd ** 0.5)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_norm_and_attention_wrappers_raise_on_bad_layouts(cuda):
    """The flash kernels take strided views: a transposed q is read where it
    lies and matches the plain version. What they cannot take raises: a
    stride on hd other than 1, and an hd with no instantiation."""
    x = torch.zeros((8, 64), device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        trms.rmsnorm(x, torch.ones(32, device=cuda))
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 128)).astype(
        np.float32)).to(cuda).transpose(1, 2)
    torch.testing.assert_close(tflash.flash_attention(q, q, q),
                               flash_attention_ref(q, q, q),
                               atol=TOL_FLASH["float32"],
                               rtol=TOL_FLASH["float32"])
    q = torch.zeros((1, 2, 16, 256), device=cuda)[..., ::2]
    with pytest.raises(ValueError):     # hd's stride is 2
        tflash.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError):     # hd 32 has no instantiation
        tflash.flash_attention(q, q, q)


@pytest.mark.gpu
def test_cuda_training_forward_gradients_match_cpu(cuda):
    """Nothing refuses a backward now: a backward through
    models/api.py::forward on the card runs the rmsnorm, add_rmsnorm and
    flash backward kernels, and wq, the norm scales and the embedding get
    the CPU's gradients (fp32, atol and rtol 1e-3 as the other card-vs-CPU
    checks)."""
    cfg = get_config("llama3.2-3b").smoke()
    params = init_model(torch.Generator(cuda).manual_seed(0), cfg, cuda)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                     params)
        before = dict(trms.launches, **tflash.launches)
        logits, _ = forward(p, cfg, {"tokens": torch.as_tensor(tok,
                                                                device=dev)})
        (logits * logits).mean().backward()
        if dev.type == "cuda":
            after = dict(trms.launches, **tflash.launches)
            assert after["flash_attention_bwd"] == (
                before["flash_attention_bwd"] + cfg.n_layers)
            assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
            assert after["add_rmsnorm_bwd"] == (
                before["add_rmsnorm_bwd"] + 2 * cfg.n_layers)
        grads[dev.type] = [p["blocks"]["attn"]["wq"].grad,
                           p["blocks"]["norm1"]["scale"].grad,
                           p["blocks"]["norm2"]["scale"].grad,
                           p["io"]["norm_f"]["scale"].grad,
                           p["io"]["embed"].grad]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert a is not None and float(b.abs().max()) > 0
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_cuda_generate_matches_cpu(cuda):
    """The fp32 smoke llama (GQA) served on the card, through the kernels,
    gives the CPU's greedy tokens."""
    cfg = get_config("llama3.2-3b").smoke()
    params = init_model(torch.Generator(cuda).manual_seed(0), cfg, cuda)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    engine = ServeEngine(cfg, params, max_len=64, device=cuda)
    engine.generate({"tokens": tok}, n_new=2)   # captures the decode step
    before = dict(trms.launches, **tflash.launches)
    got = engine.generate({"tokens": tok}, n_new=6)
    # 7 forwards (prefill, 6 graph replays) of 2 blocks: one rmsnorm and
    # four add_rmsnorm each
    assert trms.launches["rmsnorm"] == before["rmsnorm"] + 7
    assert trms.launches["add_rmsnorm"] == before["add_rmsnorm"] + 4 * 7
    assert (tflash.launches["flash_attention"]
            == before["flash_attention"] + 2)
    cpu = tree_map(lambda t: t.cpu(), params)
    exp = ServeEngine(cfg, cpu, max_len=64, device="cpu").generate(
        {"tokens": tok}, n_new=6)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,dtype", [(2048, 3072, "bfloat16"),
                                       (4, 3072, "bfloat16"),
                                       (2048, 3072, "float32"),
                                       (4, 3072, "float32"),
                                       (64, 777, "float32"),
                                       (64, 777, "bfloat16"),
                                       (2048, 3584, "bfloat16"),
                                       (4, 3584, "bfloat16")])
def test_cuda_add_rmsnorm_is_add_then_rmsnorm_bitwise(cuda, N, d, dtype):
    rng = np.random.default_rng(N + d)
    tdt = getattr(torch, dtype)
    x, delta = (torch.from_numpy(rng.standard_normal((N, d)).astype(
        np.float32)).to(cuda, tdt) for _ in range(2))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(cuda, tdt)
    before = trms.launches["add_rmsnorm"]
    s, y = trms.add_rmsnorm(x, delta, sc)
    torch.cuda.synchronize()
    assert trms.launches["add_rmsnorm"] == before + 1
    assert torch.equal(s, x + delta)
    assert torch.equal(y, trms.rmsnorm(x + delta, sc))


@pytest.mark.gpu
def test_cuda_add_rmsnorm_gradients_match_cpu(cuda):
    """Nothing refuses a backward now: through add_rmsnorm on the card both
    x and delta get the gradient of s plus the norm's, equal to the CPU's
    (plain autograd); a loss on s alone passes straight through."""
    rng = np.random.default_rng(5)
    x0, d0 = (rng.standard_normal((4, 64)).astype(np.float32)
              for _ in range(2))
    sc0 = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    got = {}
    for dev in (cuda, torch.device("cpu")):
        x, delta, sc = (torch.from_numpy(a).to(dev).requires_grad_(True)
                        for a in (x0, d0, sc0))
        s, y = trms.add_rmsnorm(x, delta, sc)
        (s.sum() + (y * w.to(dev)).sum()).backward()
        got[dev.type] = (x.grad, delta.grad, sc.grad)
        x2 = torch.from_numpy(x0).to(dev).requires_grad_(True)
        s2, _ = trms.add_rmsnorm(x2, torch.from_numpy(d0).to(dev),
                                 torch.from_numpy(sc0).to(dev))
        s2.sum().backward()
        assert torch.equal(x2.grad.cpu(), torch.ones((4, 64)))
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,dtype", [(2048, 3072, "bfloat16"),
                                       (2048, 256, "bfloat16"),
                                       (2048, 3072, "float32"),
                                       (2048, 256, "float32"),
                                       (1000, 3072, "bfloat16"),
                                       (1000, 3072, "float32"),
                                       (64, 777, "float32"),
                                       (64, 777, "bfloat16"),
                                       (2048, 3584, "bfloat16"),
                                       (2048, 3584, "float32")])
@pytest.mark.parametrize("variant", ["rmsnorm", "add", "add_no_gs"])
def test_cuda_rmsnorm_bwd_matches_plain(cuda, N, d, dtype, variant):
    """The norm backward kernels against their plain closed forms, at the
    norm tolerances; two launches bitwise equal (dscale summed in a fixed
    order)."""
    rng = np.random.default_rng(N * 7 + d)
    tdt = getattr(torch, dtype)
    x, dy, gs = (torch.from_numpy(rng.standard_normal((N, d)).astype(
        np.float32)).to(cuda, tdt) for _ in range(3))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(cuda, tdt)
    if variant == "rmsnorm":
        name = "rmsnorm_bwd"
        run = lambda: trms.rmsnorm_bwd(x, sc, dy)
        exp = ref.rmsnorm_bwd_ref(x, sc, dy)
    else:
        name = "add_rmsnorm_bwd"
        g = gs if variant == "add" else None
        run = lambda: trms.add_rmsnorm_bwd(x, sc, g, dy)
        exp = ref.add_rmsnorm_bwd_ref(x, sc, g, dy)
    before = trms.launches[name]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert trms.launches[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    tol = TOL_NORM[dtype]
    torch.testing.assert_close(got[0].float(), exp[0].float(), atol=tol,
                               rtol=tol)
    # dscale is a sum over N rows, taken in another order than the plain
    # version's: its absolute tolerance grows as the sum's spread, sqrt(N)
    torch.testing.assert_close(got[1].float(), exp[1].float(),
                               atol=tol * N ** 0.5, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("B,H,KV,S,hd,window,dtype", [
    (4, 24, 8, 512, 128, 0, "bfloat16"),
    (4, 24, 8, 512, 128, 0, "float32"),
    (4, 4, 4, 512, 64, 0, "bfloat16"),
    (2, 4, 2, 300, 128, 0, "float32"),
    (2, 4, 2, 300, 64, 0, "bfloat16"),
    (1, 4, 4, 256, 128, 64, "float32"),
    (1, 4, 2, 300, 64, 64, "bfloat16"),
    (1, 2, 2, 130, 64, 16, "float32"),
    (4, 24, 8, 300, 128, 64, "bfloat16"),
    (8, 16, 4, 300, 64, 48, "bfloat16"),
    (4, 12, 2, 512, 128, 0, "bfloat16"),
    (4, 12, 2, 512, 128, 0, "float32"),
    (4, 24, 24, 512, 64, 0, "bfloat16"),
    (4, 24, 24, 512, 64, 0, "float32"),
    *HD112_CASES])
def test_cuda_flash_attention_bwd_matches_plain(cuda, B, H, KV, S, hd, window,
                                                dtype, layout):
    """The flash backward kernels against the plain closed form on the
    card, from the forward kernel's o and lse; two launches bitwise equal;
    the forward's o is the same bits with and without lse."""
    q, k, v = _flash_inputs(B, H, KV, S, hd, dtype, layout, cuda)
    o, lse = tflash._launch(q, k, v, True, window, with_lse=True)
    assert torch.equal(o, tflash.flash_attention(q, k, v,
                                                 sliding_window=window))
    _, exp_lse = flash_attention_ref(q, k, v, sliding_window=window,
                                     return_lse=True)
    torch.testing.assert_close(lse, exp_lse, atol=TOL_FLASH["float32"],
                               rtol=TOL_FLASH["float32"])
    do = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, S, H, hd)).astype(np.float32)).to(cuda, q.dtype).transpose(1, 2)
    before = tflash.launches["flash_attention_bwd"]
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do,
                                     sliding_window=window)
    again = tflash.flash_attention_bwd(q, k, v, o, lse, do,
                                       sliding_window=window)
    torch.cuda.synchronize()
    assert tflash.launches["flash_attention_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exp = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                      sliding_window=window)
    for a, b, t in zip(got, exp, (q, k, v)):
        assert a.shape == t.shape and a.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=TOL_FLASH[dtype],
                                   rtol=TOL_FLASH[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("C,B,V,dtype", [(8, 32, 10, "float32"),
                                         (4, 32, 10, "float32"),
                                         (2, 32, 777, "float32"),
                                         (2, 32, 777, "bfloat16"),
                                         (4, 512, 32000, "float32"),
                                         (4, 512, 32000, "bfloat16"),
                                         (1, 1024, 2048, "float32"),
                                         (1, 1024, 2048, "bfloat16"),
                                         (1, 1024, 2049, "float32"),
                                         (1, 1024, 2049, "bfloat16"),
                                         # either side of the warp / row
                                         # kernel switch, and the 16-block
                                         # cluster of the widest rows
                                         (2, 8, 128, "float32"),
                                         (2, 8, 136, "float32"),
                                         (2, 64, 151936, "float32"),
                                         (2, 64, 151936, "bfloat16"),
                                         # rows off 16 bytes (scalar
                                         # staging) in clusters of 2, 8
                                         # and 16 blocks
                                         (2, 8, 13825, "float32"),
                                         (2, 8, 110593, "float32"),
                                         (2, 8, 151937, "float32"),
                                         (2, 8, 27649, "bfloat16"),
                                         (2, 8, 151937, "bfloat16"),
                                         (2, 8, 221185, "bfloat16")])
def test_cuda_kd_loss_grad_matches_plain(cuda, C, B, V, dtype):
    """Gradients, batch means and accuracies at chip_smoke.py's
    kd_loss_grad limits (fp32 gradients within rtol 1e-4 plus 2^-16 of the
    tensor's max|ref|), two launches bitwise equal (no float atomics), and
    the last client bitwise a one-client call on its rows."""
    x, y, lab = _inputs(C * B, V, seed=9)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda, tdt).view(C, B, V)
    yt = torch.from_numpy(y).to(cuda, tdt).view(C, B, V)
    labt = torch.from_numpy(lab).to(cuda).view(C, B)
    lam = (0.4, 0.6, 0.5, 0.5)
    before = tkd.launches["kd_loss_grad"]
    got = tkd.kd_loss_grad(xt, yt, labt, lam)
    again = tkd.kd_loss_grad(xt, yt, labt, lam)
    one = tkd.kd_loss_grad(xt[-1], yt[-1], labt[-1], lam)
    torch.cuda.synchronize()
    assert tkd.launches["kd_loss_grad"] == before + 3
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(one[0], got[0][-1]) and torch.equal(one[1], got[1][-1])
    assert torch.equal(one[2][:, 0], got[2][:, -1])
    close_kd_grad(torch, got, kd_loss_grad_ref(xt, yt, labt, lam),
                  f"kd_loss_grad {C}x{B}x{V} {dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 16])
def test_cuda_graphed_generate_is_the_eager_decode_loop(cuda, window):
    """generate replays the captured decode step; its tokens and every
    step's logits equal an eager loop of make_decode_step on the card bit
    for bit, also across a 16-slot ring buffer's wrap."""
    import dataclasses
    cfg = dataclasses.replace(get_config("llama3.2-3b").smoke(),
                              dtype=torch.bfloat16, sliding_window=window)
    params = init_model(torch.Generator(cuda).manual_seed(3), cfg, cuda)
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)), device=cuda)
    engine = ServeEngine(cfg, params, max_len=48, device=cuda)
    got, logits = engine.generate({"tokens": tok}, n_new=20,
                                  return_logits=True)
    assert engine.decode_step_for(2).graph is not None
    step = make_decode_step(cfg)
    with torch.no_grad():
        first, pre = prefill(params, cfg, {"tokens": tok})
        cache = make_decode_cache(cfg, 2, 48, cuda)
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :12] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device=cuda)
        for i in range(20):
            index.fill_(12 + i)
            nxt, lg, cache = step(params, {"tokens": nxt[:, None]}, cache,
                                  index)
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.cpu().numpy(), got[:, i])


@pytest.mark.gpu
def test_cuda_moe_graphed_decode_is_the_eager_decode_loop(cuda):
    """The MoE smoke model (qwen3-moe, bf16) served on the card: its decode
    step, routing and capacity dispatch included, is captured into a CUDA
    graph, and the graphed generate's tokens and every step's logits equal
    an eager loop of make_decode_step bit for bit."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype=torch.bfloat16)
    params = init_model(torch.Generator(cuda).manual_seed(4), cfg, cuda)
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 12)), device=cuda)
    engine = ServeEngine(cfg, params, max_len=48, device=cuda)
    got, logits = engine.generate({"tokens": tok}, n_new=16,
                                  return_logits=True)
    assert engine.decode_step_for(4).graph is not None
    step = make_decode_step(cfg)
    with torch.no_grad():
        first, pre = prefill(params, cfg, {"tokens": tok})
        cache = make_decode_cache(cfg, 4, 48, cuda)
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :12] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device=cuda)
        for i in range(16):
            index.fill_(12 + i)
            nxt, lg, cache = step(params, {"tokens": nxt[:, None]}, cache,
                                  index)
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.cpu().numpy(), got[:, i])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_cuda_vlm_audio_graphed_generate_is_the_eager_decode_loop(cuda, arch):
    """The VLM (patch embeddings, M-RoPE; each decode step gathers its
    tokens' embedding rows inside the graph) and the audio model ((B, 1,
    nq) codebook tokens, per-codebook heads) served on the card at their
    bf16 smoke cuts: the graphed generate's tokens and every step's logits
    equal an eager loop of make_decode_step bit for bit."""
    import dataclasses

    from repro_torch.models.api import dummy_batch
    from repro_torch.serve import decode_batch
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=torch.bfloat16)
    params = init_model(torch.Generator(cuda).manual_seed(6), cfg, cuda)
    batch = dummy_batch(cfg, 3, 12, torch.Generator(cuda).manual_seed(6),
                        with_labels=False, device=cuda)
    engine = ServeEngine(cfg, params, max_len=48, device=cuda)
    got, logits = engine.generate(batch, n_new=16, return_logits=True)
    assert engine.decode_step_for(3).graph is not None
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert got.shape == (3, 16) + nq
    step = make_decode_step(cfg)
    with torch.no_grad():
        first, pre = prefill(params, cfg, batch)
        cache = make_decode_cache(cfg, 3, 48, cuda)
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :12] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device=cuda)
        for i in range(16):
            index.fill_(12 + i)
            nxt, lg, cache = step(params,
                                  decode_batch(cfg, params, nxt[:, None]),
                                  cache, index)
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.cpu().numpy(), got[:, i])


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_cuda_apply_moe_matches_cpu(cuda, cf):
    """apply_moe (fp32, qwen3-moe's 128 experts, top-8, at d 256) on the
    card against the CPU on the same weights: equal expert indices and
    dropped pairs, y at atol and rtol 1e-5, the aux losses at 1e-5."""
    import dataclasses

    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), d_model=256,
                              moe_d_ff=256, dtype=torch.float32,
                              capacity_factor=cf)
    params = moe.init_moe(torch.Generator(cuda).manual_seed(5), cfg, cuda)
    x = torch.randn((2, 64, 256), generator=torch.Generator(
        cuda).manual_seed(6), device=cuda)
    out = {}
    with torch.no_grad():
        for dev in (cuda, torch.device("cpu")):
            p = tree_map(lambda t: t.to(dev), params)
            xx = x.to(dev)
            y, aux = moe.apply_moe(p, cfg, xx)
            _, probs, _, top_i = moe.route(p["router"], cfg,
                                           xx.view(-1, 256))
            C = moe.expert_capacity(128, cfg.top_k, cfg.n_experts, cf)
            _, keep = moe.dispatch_slots(top_i, cfg.n_experts, C)
            out[dev.type] = (y.cpu(), {k: float(v) for k, v in aux.items()},
                             top_i.cpu(), keep.cpu())
    (yg, ag, ig, kg), (yc, ac, ic, kc) = out["cuda"], out["cpu"]
    srt = probs.sort(-1, descending=True).values
    gap = float((srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min())
    assert torch.equal(ig, ic) and torch.equal(kg, kc), (
        f"routes differ; the smallest k-th / (k+1)-th gap is {gap}")
    assert bool(kc.all()) == (cf == 8.0)
    torch.testing.assert_close(yg, yc, atol=1e-5, rtol=1e-5)
    for k in ac:
        assert abs(ag[k] - ac[k]) <= 1e-5 * max(1.0, abs(ac[k])), k


def _ssm_cut(name, dtype):
    """The SSM family's smoke cuts: xlstm-1.3b's with slstm_every 2 over 3
    layers (a group of one mLSTM and one sLSTM block, then an mLSTM tail),
    zamba2-7b's (2 Mamba2 blocks and the shared attention block), the same
    at zamba2-7b's head dim (d 224 over 2 heads: hd 112) and its
    pure-Mamba2 LiteModel."""
    import dataclasses
    if name == "xlstm":
        cfg = dataclasses.replace(get_config("xlstm-1.3b").smoke(),
                                  n_layers=3)
    elif name == "zamba2_hd112":
        cfg = dataclasses.replace(get_config("zamba2-7b").smoke(),
                                  d_model=224, n_heads=2, n_kv_heads=2,
                                  head_dim=112)
    else:
        cfg = get_config("zamba2-7b").smoke()
        cfg = cfg.lite() if name == "mamba2" else cfg
    return dataclasses.replace(cfg, dtype=dtype)


def _zamba2_published_cut(dtype):
    """Zamba2 as published, cut to a test's size with its shapes kept: hd
    224 (d 448 over 4 heads at width 2 d), 2 groups of 7 Mamba2 heads, 2
    shared blocks over calls at layers 1 and 3, adapters of rank 8."""
    return dataclasses.replace(
        get_config("zamba2-7b-instruct"), n_layers=4, d_model=448,
        n_heads=4, n_kv_heads=4, head_dim=224, d_ff=256, vocab_size=256,
        ssm_state=16, hybrid_layer_ids=(1, 3), shared_mlp_adapter_rank=8,
        dtype=dtype)


@pytest.mark.gpu
def test_cuda_zamba2_published_graphed_generate_carries_state(cuda):
    """Zamba2 as published in bf16 on the card (flash at hd 224): the
    graphed generate starts its decode from the prompt's state (the
    engine's cache ends in the eager loop's state after a prefill loaded
    with carry) and its tokens and logits equal the eager loop's bit for
    bit; with carry_prompt_state off the tokens differ."""
    from repro_torch.serve.engine import _load_prefill
    cfg = _zamba2_published_cut(torch.bfloat16)
    params = init_model(torch.Generator(cuda).manual_seed(8), cfg, cuda)
    tok = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 140)), device=cuda)
    engine = ServeEngine(cfg, params, max_len=192, device=cuda)
    before = tflash.launches["flash_attention"]
    got, logits = engine.generate({"tokens": tok}, n_new=16,
                                  return_logits=True)
    assert tflash.launches["flash_attention"] == before + 2
    st = engine.decode_step_for(3)
    assert st.graph is not None
    step = make_decode_step(cfg)
    with torch.no_grad():
        first, pre = prefill(params, cfg, {"tokens": tok})
        cache = make_decode_cache(cfg, 3, 192, cuda)
        _load_prefill(cache, pre, carry=True)
        nxt = first[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device=cuda)
        for i in range(16):
            index.fill_(140 + i)
            nxt, lg, cache = step(params, {"tokens": nxt[:, None]}, cache,
                                  index)
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.cpu().numpy(), got[:, i])
    for a, b in zip(tree_leaves(st.cache), tree_leaves(cache)):
        assert torch.equal(a, b)
    engine.cfg = dataclasses.replace(cfg, carry_prompt_state=False)
    assert not np.array_equal(engine.generate({"tokens": tok}, n_new=16),
                              got)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xlstm", "zamba2", "zamba2_hd112",
                                  "mamba2"])
def test_cuda_ssm_graphed_generate_is_the_eager_decode_loop(cuda, name):
    """The SSM family served on the card in bf16 (chip_smoke.py phases 5h
    and 9g at smoke size): the decode step, captured into a CUDA graph,
    writes every recurrent state back into the graph's static cache, so
    the graphed generate's tokens and every step's logits equal an eager
    loop of make_decode_step bit for bit, and the engine's cache ends in
    the loop's state."""
    from repro_torch.serve.engine import _load_prefill
    cfg = _ssm_cut(name, torch.bfloat16)
    params = init_model(torch.Generator(cuda).manual_seed(8), cfg, cuda)
    tok = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 12)), device=cuda)
    engine = ServeEngine(cfg, params, max_len=48, device=cuda)
    got, logits = engine.generate({"tokens": tok}, n_new=16,
                                  return_logits=True)
    st = engine.decode_step_for(3)
    assert st.graph is not None
    step = make_decode_step(cfg)
    with torch.no_grad():
        first, pre = prefill(params, cfg, {"tokens": tok})
        cache = make_decode_cache(cfg, 3, 48, cuda)
        _load_prefill(cache, pre)
        nxt = first[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device=cuda)
        for i in range(16):
            index.fill_(12 + i)
            nxt, lg, cache = step(params, {"tokens": nxt[:, None]}, cache,
                                  index)
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.cpu().numpy(), got[:, i])
    for a, b in zip(tree_leaves(st.cache), tree_leaves(cache)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xlstm", "zamba2", "zamba2_hd112",
                                  "mamba2"])
def test_cuda_ssm_prefill_decode_and_gradients_match_cpu(cuda, name):
    """The SSM family on the card against the CPU in fp32 (chip_smoke.py
    phase 5i at smoke size): prefill logits and every state, 4 decode steps
    from the prefill's state, and a backward through forward (the sLSTM's
    time loop, the chunk scans' masked exps), at atol and rtol 1e-3."""
    cfg = _ssm_cut(name, torch.float32)
    params = init_model(torch.Generator(cuda).manual_seed(9), cfg, cuda)
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 132))
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                     params)
        t = torch.as_tensor(tok, device=dev)
        with torch.no_grad():
            first, pre = prefill(p, cfg, {"tokens": t[:, :128]})
            cache = make_decode_cache(cfg, 2, 132, dev)
            for big, small in zip(tree_leaves(cache), tree_leaves(pre)):
                big[tuple(slice(0, n) for n in small.shape)] = small
            steps = [first]
            for i in range(4):
                lg, cache = decode_step(p, cfg, {"tokens": t[:, 128 + i:
                                                             129 + i]},
                                        cache, 128 + i)
                steps.append(lg)
        logits, _ = forward(p, cfg, {"tokens": t[:, :128]})
        (logits * logits).mean().backward()
        out.append(([x.cpu() for x in steps + tree_leaves(cache)],
                    [x.grad.cpu() for x in tree_leaves(p)]))
    (card, card_grads), (host, host_grads) = out
    for a, b in zip(card, host):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    for a, b in zip(card_grads, host_grads):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xlstm", "zamba2", "zamba2_hd112"])
def test_cuda_ssm_train_step_launches_and_matches_cpu(cuda, name):
    """One train step of the SSM family with its LiteModel on the card
    (chip_smoke.py phases 9f and 9g at smoke size), fp32: one kd_loss_grad
    launch, the hybrid's norm and flash kernels and their backwards, and
    the loss, grad norm and new params of the CPU's step at 1e-3."""
    import dataclasses

    from repro_torch.train import TrainStepConfig, make_hapfl_train_step
    from repro_torch.train import make_train_state
    cfg = _ssm_cut(name, torch.float32)
    lite = dataclasses.replace(cfg.lite(), remat=False)
    tcfg = TrainStepConfig()
    gpu = make_train_state(torch.Generator(cuda).manual_seed(10), cfg, lite,
                           tcfg, cuda)
    cpu = tree_map(lambda t: t.detach().cpu().clone(), gpu)
    rng = np.random.default_rng(10)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 64)) for k in
             ("tokens", "labels")}
    out = []
    for dev, state in ((cuda, gpu), (torch.device("cpu"), cpu)):
        step = make_hapfl_train_step(cfg, lite, tcfg)
        before = dict(tkd.launches, **trms.launches, **tflash.launches)
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in batch.items()})
        after = dict(tkd.launches, **trms.launches, **tflash.launches)
        if dev.type == "cuda":
            ran = {k: after[k] - before[k] for k in after}
            hybrid = name.startswith("zamba2")
            assert ran["kd_loss_grad"] == 1
            assert ran["flash_attention"] == ran["flash_attention_bwd"] == (
                1 if hybrid else 0)
            # zamba2: 4 block norms, its LiteModel 2; xlstm: layernorm
            assert ran["rmsnorm"] == ran["rmsnorm_bwd"] == (2 if hybrid
                                                            else 0)
            assert ran["add_rmsnorm"] == ran["add_rmsnorm_bwd"] == (
                6 if hybrid else 0)
        out.append(({k: float(v) for k, v in m.items()},
                    [t.detach().cpu() for t in tree_leaves(state["params"])]))
    (card_m, card_p), (host_m, host_p) = out
    for k, v in host_m.items():
        assert abs(card_m[k] - v) <= 1e-3 * max(1.0, abs(v)), k
    for a, b in zip(card_p, host_p):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_cuda_kernels_unchanged_by_the_meta_path(cuda):
    """Each kernel, at one shape: a call on meta tensors (the dry run's)
    launches nothing and records its formula's work; the CUDA calls before
    and after it give bitwise equal results, one launch each."""
    from repro_torch.kernels import cost
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    x, dlt, dy = rnd(512, 3072), rnd(512, 3072), rnd(512, 3072)
    sc = rnd(3072)
    q = rnd(2, 512, 24, 128).transpose(1, 2)
    k, v = (rnd(2, 512, 8, 128).transpose(1, 2) for _ in range(2))
    o, lse = tflash._launch(q, k, v, True, 0, with_lse=True)
    do = rnd(2, 512, 24, 128).transpose(1, 2)
    xl, yl = rnd(256, 32000), rnd(256, 32000)
    lab = torch.randint(0, 32000, (256,), generator=g, device="cuda")
    _, stats = tkd.kd_loss_fwd(xl, yl, lab)
    grads = torch.randn((4, 256), generator=g, device="cuda")
    calls = {
        "rmsnorm": (trms, lambda *t: trms.rmsnorm(*t), (x, sc)),
        "add_rmsnorm": (trms, lambda *t: trms.add_rmsnorm(*t), (x, dlt, sc)),
        "rmsnorm_bwd": (trms, lambda *t: trms.rmsnorm_bwd(*t), (x, sc, dy)),
        "add_rmsnorm_bwd": (trms, lambda *t: trms.add_rmsnorm_bwd(*t),
                            (x, sc, dlt, dy)),
        "flash_attention": (tflash, lambda *t: tflash.flash_attention(*t),
                            (q, k, v)),
        "flash_attention_bwd": (tflash,
                                lambda *t: tflash.flash_attention_bwd(*t),
                                (q, k, v, o, lse, do)),
        "kd_loss_fwd": (tkd, lambda *t: tkd.kd_loss_fwd(*t), (xl, yl, lab)),
        "kd_loss_bwd": (tkd, lambda *t: tkd.kd_loss_bwd(*t),
                        (xl, yl, lab, stats, grads)),
        "kd_loss_grad": (tkd, lambda *t: tkd.kd_loss_grad(
            *t, (0.4, 0.6, 0.5, 0.5)), (xl[None], yl[None], lab[None])),
    }
    for name, (mod, fn, args) in calls.items():
        n0 = mod.launches[name]
        first = fn(*args)
        torch.cuda.synchronize()
        assert mod.launches[name] == n0 + 1, name
        meta = [t.to("meta") if isinstance(t, torch.Tensor) else t
                for t in args]
        with cost.counting() as tally:
            out = fn(*meta)
        assert mod.launches[name] == n0 + 1, name
        assert tally[name]["calls"] == 1 and tally[name]["bytes"] > 0, name
        for t, m in zip(first if isinstance(first, tuple) else (first,),
                        out if isinstance(out, tuple) else (out,)):
            assert m.is_meta and m.shape == t.shape and m.dtype == t.dtype
        again = fn(*args)
        torch.cuda.synchronize()
        assert mod.launches[name] == n0 + 2, name
        for a, b in zip(first if isinstance(first, tuple) else (first,),
                        again if isinstance(again, tuple) else (again,)):
            assert torch.equal(a, b), name


# --------------------------------------------------------------------- #
# phase spans (repro_torch.obs.trace.phase) on the card
# --------------------------------------------------------------------- #
def _moe_train(cuda, seed=11):
    import dataclasses

    from repro_torch.models.api import dummy_batch
    from repro_torch.train import (TrainStepConfig, make_hapfl_train_step,
                                   make_train_state)
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype=torch.bfloat16, remat=True)
    lite = dataclasses.replace(cfg.lite(), remat=True)
    state = make_train_state(torch.Generator(cuda).manual_seed(seed), cfg,
                             lite, device=cuda)
    batch = dummy_batch(cfg, 2, 64, device=cuda)
    return cfg, make_hapfl_train_step(cfg, lite, TrainStepConfig()), state, \
        batch


@pytest.mark.gpu
def test_cuda_phase_spans_record_ordered_device_intervals(cuda):
    """Both of the benchmark's profiles (the device alone, and the host with
    the device) set the flag the spans follow; a train step's spans and a
    generate's carry positive device intervals from CUDA events, each
    inside its root, siblings in order, replays one after another."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    trace.profiled(clear=True)
    cfg, step, state, batch = _moe_train(cuda)
    step(state, batch)                       # warm
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=acts):
            assert trace.phase("probe").recording
            step(state, batch)
            torch.cuda.synchronize()
    got = trace.profiled(clear=True)
    roots = [s for s in got if s["name"] == "train.step"]
    assert len(roots) == 2
    for r in roots:
        kids = [s for s in got if s["root"] == r["seq"] and s is not r]
        assert len([s for s in kids if s["name"] == "moe.layer"]) == \
            2 * cfg.n_layers
        assert r["device"][0] == 0.0 and r["device"][1] > 0.0
        for s in kids:
            d0, d1 = s["device"]
            assert 0.0 <= d0 < d1 <= r["device"][1], s
        by = {s["name"]: s for s in kids}
        assert by["train.loss_and_grads"]["device"][1] <= \
            by["train.update"]["device"][0]
        assert by["train.loss_and_grads"]["device"][0] <= \
            by["train.backward"]["device"][0]
    engine = ServeEngine(cfg, state["params"]["local"], max_len=48,
                         device=cuda)
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)), device=cuda)
    engine.generate({"tokens": tok}, n_new=6)  # capture
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.generate({"tokens": tok}, n_new=6)
    got = trace.profiled(clear=True)
    reps = [s for s in got if s["name"] == "serve.replay"]
    assert len(reps) == 6
    assert {"mallocs", "alloc_retries"} <= set(got[0]["args"])
    for a, b in zip(reps, reps[1:]):
        assert 0.0 < a["device"][0] < a["device"][1] <= b["device"][0]
    # the graph's MoE layers add no spans: only the prefill's
    assert len([s for s in got if s["name"] == "moe.layer"]) == cfg.n_layers


@pytest.mark.gpu
def test_cuda_decode_graph_captured_with_tracing_on_replays_bitwise(cuda):
    """A decode graph captured while the tracer records replays bit for bit
    like one captured with it off: the spans add no node to the graph."""
    import dataclasses

    from repro_torch.obs import trace
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype=torch.bfloat16)
    params = init_model(torch.Generator(cuda).manual_seed(6), cfg, cuda)
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 12)), device=cuda)
    outs = []
    for traced in (False, True):
        engine = ServeEngine(cfg, params, max_len=48, device=cuda)
        tracer = trace.enable(trace.Tracer()) if traced else None
        try:
            first = engine.generate({"tokens": tok}, n_new=12,
                                    return_logits=True)
        finally:
            trace.disable()
        outs.append(first + engine.generate({"tokens": tok}, n_new=12,
                                            return_logits=True))
        if traced:
            names = [p.name for p in tracer.phases]
            # the prefill's MoE layers and the eager warm-up step's; none
            # from the capture or the replays
            assert names.count("moe.layer") == 2 * cfg.n_layers
            assert names.count("serve.replay") == 12
            trace.validate_chrome_trace(tracer.to_chrome())
            assert any(ev["pid"] == 3 for ev in
                       tracer.to_chrome()["traceEvents"] if ev["ph"] == "X")
    for a, b in zip(outs[0], outs[1]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_phase_spans_add_no_sync(cuda):
    """A span itself never waits for the card (sync debug mode "error"
    around spans recording device events), and a traced train step makes
    no more synchronising calls than the untraced step."""
    import warnings

    from repro_torch.obs import trace
    x = torch.ones((256, 256), device=cuda)
    tracer = trace.enable(trace.Tracer())
    try:
        torch.cuda.set_sync_debug_mode("error")
        with trace.phase("outer"):
            for _ in range(3):
                with trace.phase("inner", n=1):
                    x = x @ x / 256
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.disable()
    assert len(tracer.phases) == 4
    cfg, step, state, batch = _moe_train(cuda)
    step(state, batch)
    torch.cuda.synchronize()
    counts = []
    for traced in (False, True):
        if traced:
            trace.enable(trace.Tracer())
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                trace.disable()
        counts.append(len([w for w in seen
                           if "synchroniz" in str(w.message)]))
    assert counts[1] == counts[0]


@pytest.mark.gpu
def test_cuda_phase_clocks_line_up_with_the_profiler(cuda):
    """An enabled tracer's wall span of a phase starts where the profiler's
    range of it starts, once the export's epoch offset is added (the
    profiler's host clock is the epoch clock), and its device interval lies
    where the profiler saw the phase's kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    x = torch.ones((2048, 2048), device=cuda)
    x @ x
    tracer = trace.enable(trace.Tracer())
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with trace.phase("probe.clock"):
                for _ in range(8):
                    x = x @ x / 2048
            torch.cuda.synchronize()
    finally:
        trace.disable()
    trace.profiled(clear=True)
    chrome = tracer.to_chrome()
    epoch0 = chrome["otherData"]["epoch_ns_at_ts0"]
    rows = [ev for ev in chrome["traceEvents"]
            if ev.get("name") == "probe.clock"]
    host = next(ev for ev in rows if ev["pid"] == 1)
    dev = next(ev for ev in rows if ev["pid"] == 3)
    kr = prof.profiler.kineto_results
    rng = next(e for e in kr.events() if e.name() == "probe.clock"
               and e.device_type() == torch.autograd.DeviceType.CPU)
    gemms = [e for e in kr.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and e.name() != "probe.clock" and e.duration_ns() > 0]
    host_ns = epoch0 + host["ts"] * 1e3
    assert abs(rng.start_ns() - host_ns) < 2e6
    first = min(e.start_ns() for e in gemms)
    last = max(e.start_ns() + e.duration_ns() for e in gemms)
    dev_ns = epoch0 + dev["ts"] * 1e3
    assert abs(first - dev_ns) < 2e6
    assert abs(last - (dev_ns + dev["dur"] * 1e3)) < 2e6


@pytest.mark.gpu
@pytest.mark.parametrize("shape", decode_shapes())
def test_cuda_decode_attention_matches_float64(cuda, shape):
    """(B, H, KV, L, hd, dtype) at kv_valid 1, 545, L and past a wrap:
    within chip_smoke's TOL_DECODE of float64, no further than the plain
    version (or DECODE_FLOOR), two launches bitwise."""
    for index in decode_positions(shape[3]):
        check_decode_attention(torch, shape, index)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DECODE_GRAPHED)
def test_cuda_decode_attention_graph_replay_is_eager_bitwise(cuda, shape):
    check_decode_graph(torch, shape)


@pytest.mark.gpu
def test_cuda_decode_attention_raises_on_a_host_position(cuda):
    from repro_torch.kernels import decode_attention as da
    q = torch.zeros((2, 1, 8, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((2, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="0-d int64"):
        da.decode_attention(q, k, k, 5)
    with pytest.raises(ValueError, match="0-d int64"):
        da.decode_attention(q, k, k, torch.tensor(5))
