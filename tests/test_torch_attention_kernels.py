"""rmsnorm and flash attention in the port: the plain versions against the
reference's Pallas kernels (interpret mode) and model functions, the
wrappers' CPU path and checks (strided views included), the views prefill
hands the flash wrapper, the port's gqa_attention, the port's mutual-KD
loss against the reference's ops.mutual_kd_loss, and the kernels/ops.py
entry points on the model path. The CUDA kernels are held against the plain versions on a card by tests/test_torch_gpu.py.

Tolerance 1e-5 in fp32 unless noted; bf16 2e-2, as in tests/test_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.core import distill as tdistill
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.utils.pytree import tree_map

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------- #
# rmsnorm
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("N,d", [(64, 128), (256, 512), (32, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_pallas(N, d, dtype):
    x, sc = _normal((N, d), 1), 1 + 0.1 * _normal((d,), 2)
    exp = pallas_rmsnorm(jnp.asarray(x).astype(dtype),
                         jnp.asarray(sc).astype(dtype), block_n=32,
                         interpret=True)
    tdt = getattr(torch, dtype)
    got = rmsnorm_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(sc).to(tdt))
    assert got.dtype == tdt
    _close(got.float(), exp, TOL[dtype])


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_matches_reference(kind):
    """The port's apply_norm (rmsnorm through the wrapper's CPU path) on
    (B, S, d) against the reference's apply_norm."""
    x = _normal((2, 5, 96), 3, scale=2.0)
    params = {"scale": 1 + 0.1 * _normal((96,), 4),
              "bias": 0.1 * _normal((96,), 5)}
    exp = jlayers.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), kind)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in
                              params.items()}, torch.from_numpy(x), kind)
    _close(got, exp, 1e-5)


def test_rmsnorm_wrapper_cpu_path_and_checks():
    """CPU tensors take the plain version, uncounted, at any N and d; bad
    shapes and dtypes raise on every device."""
    before = dict(trms.launches)
    for N, d in [(1000, 64), (3, 777)]:
        x = torch.from_numpy(_normal((N, d), N))
        sc = torch.from_numpy(1 + _normal((d,), d))
        assert torch.equal(trms.rmsnorm(x, sc), rmsnorm_ref(x, sc))
    assert trms.launches == before
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        trms.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError):
        trms.rmsnorm(torch.zeros((2, 4, 8)), torch.ones(8))
    with pytest.raises(TypeError):
        trms.rmsnorm(x, torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        trms.rmsnorm(x.double(), torch.ones(8, dtype=torch.float64))


# ---------------------------------------------------------------------- #
# flash attention
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_pallas(window, dtype):
    """H = KV, causal, the Pallas kernel in interpret mode."""
    B, H, S, hd = 1, 2, 64, 64
    q, k, v = (_normal((B, H, S, hd), s) for s in (10, 11, 12))
    exp = pallas_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                       causal=True, sliding_window=window, block_q=32,
                       block_k=32, interpret=True)
    tdt = getattr(torch, dtype)
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt) for a in
                                (q, k, v)), causal=True,
                              sliding_window=window)
    assert got.dtype == tdt
    _close(got.float(), exp, TOL[dtype])


@pytest.mark.parametrize("H,KV,window", [(4, 2, 0), (4, 1, 8), (6, 3, 5)])
def test_flash_ref_matches_gqa_attention(H, KV, window):
    """KV < H: query head h reads KV head h // (H / KV), as the reference
    model's gqa_attention groups them; a ragged S."""
    B, S, hd = 2, 48, 32
    q = _normal((B, S, H, hd), 20)
    k, v = _normal((B, S, KV, hd), 21), _normal((B, S, KV, hd), 22)
    exp = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, sliding_window=window)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = flash_attention_ref(t(q), t(k), t(v), causal=True,
                              sliding_window=window).transpose(1, 2)
    _close(got, exp, 1e-5)


def test_flash_wrapper_cpu_path_and_checks():
    before = dict(tflash.launches)
    q = torch.from_numpy(_normal((1, 4, 37, 16), 30))
    kv = torch.from_numpy(_normal((1, 2, 37, 16), 31))
    assert torch.equal(tflash.flash_attention(q, kv, kv, sliding_window=7),
                       flash_attention_ref(q, kv, kv, sliding_window=7))
    assert tflash.launches == before
    with pytest.raises(ValueError):     # H not a multiple of KV
        tflash.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError):     # S differs
        tflash.flash_attention(q, kv[:, :, :5], kv[:, :, :5])
    with pytest.raises(ValueError):
        tflash.flash_attention(q, kv, kv, sliding_window=-1)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, kv.bfloat16(), kv.bfloat16())


@pytest.mark.parametrize("H,KV,S,window", [(4, 4, 37, 0), (6, 2, 37, 7),
                                           (6, 2, 40, 0)])
def test_flash_wrapper_takes_strided_views(H, KV, S, window):
    """The transposed views of (B, S, H, hd) tensors, which apply_attention
    passes, give exactly what contiguous copies give: a ragged S, a window
    and grouped KV heads (H / KV = 3)."""
    B, hd = 2, 16
    q = torch.from_numpy(_normal((B, S, H, hd), 80)).transpose(1, 2)
    k = torch.from_numpy(_normal((B, S, KV, hd), 81)).transpose(1, 2)
    v = torch.from_numpy(_normal((B, S, KV, hd), 82)).transpose(1, 2)
    assert not q.is_contiguous()
    got = tflash.flash_attention(q, k, v, sliding_window=window)
    exp = tflash.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), sliding_window=window)
    assert torch.equal(got, exp)


def test_apply_attention_hands_flash_views(monkeypatch):
    """Prefill hands the flash wrapper the (B, H, S, hd) views of its
    (B, S, H, hd) q, k, v projections: no .contiguous() copy around it."""
    cfg = get_config("llama3.2-3b").smoke()
    params = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention_op", record)
    x = torch.from_numpy(_normal((2, 5, cfg.d_model), 83))
    tattn.apply_attention(params, cfg, x, torch.arange(5)[None].expand(2, 5),
                          cache="init")
    (q, k, v), = seen
    for t, n in ((q, cfg.n_heads), (k, cfg.n_kv_heads), (v, cfg.n_kv_heads)):
        hd = cfg.resolved_head_dim
        assert t.shape == (2, n, 5, hd)
        assert t.stride() == (5 * n * hd, hd, n * hd, 1)
        assert t.transpose(1, 2).is_contiguous()


def test_forward_on_cpu_gives_gradients_to_attention_and_norms():
    """On the CPU the kernels' plain versions are differentiable: a training
    forward's backward reaches wq and every norm scale."""
    cfg = get_config("llama3.2-3b").smoke()
    params = tapi.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    tok = np.random.default_rng(85).integers(0, cfg.vocab_size, (2, 12))
    logits, _ = tapi.forward(params, cfg, {"tokens": torch.from_numpy(tok)})
    logits.sum().backward()
    for g in (params["blocks"]["attn"]["wq"].grad,
              params["blocks"]["norm1"]["scale"].grad,
              params["blocks"]["norm2"]["scale"].grad,
              params["io"]["norm_f"]["scale"].grad):
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0


@pytest.mark.parametrize("mode", ["causal_chunked", "decode"])
def test_gqa_attention_matches_reference(mode):
    """The port's plain gqa_attention: chunked causal queries with a window,
    and one query against a partly filled cache (kv_len_valid)."""
    B, H, KV, hd = 2, 4, 2, 16
    Sq, Skv = (40, 40) if mode == "causal_chunked" else (1, 24)
    q = _normal((B, Sq, H, hd), 40)
    k, v = _normal((B, Skv, KV, hd), 41), _normal((B, Skv, KV, hd), 42)
    kw = (dict(causal=True, sliding_window=9, q_chunk=8)
          if mode == "causal_chunked" else
          dict(causal=False, kv_len_valid=17, q_start=16))
    exp = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    got = tattn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    _close(got, exp, 1e-5)


# ---------------------------------------------------------------------- #
# kernels/ops.py and the reference's mutual_kd_loss
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("reference_path", ["plain", "kernel"])
def test_mutual_losses_match_reference_mutual_kd_loss(reference_path):
    """The port's mutual-KD loss (core.distill.mutual_losses, through the
    kd_loss wrapper) on (N, V) logits against the reference's
    ops.mutual_kd_loss: its value by either of the reference's paths, its
    metrics, and its gradients by the reference's plain path (the Pallas
    kernel has no backward)."""
    x, y = _normal((12, 50), 50, 3.0), _normal((12, 50), 51, 3.0)
    lab = np.random.default_rng(52).integers(0, 50, (12,)).astype(np.int32)
    exp, exp_m = jops.mutual_kd_loss(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(lab),
        use_kernel=reference_path == "kernel")
    exp_gx, exp_gy = jax.grad(
        lambda a, b: jops.mutual_kd_loss(a, b, jnp.asarray(lab))[0],
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    got, got_m = tdistill.mutual_losses(tx, ty, torch.from_numpy(lab))
    gx, gy = torch.autograd.grad(got, (tx, ty))
    _close(got.detach(), exp, 1e-5)
    for key in ("ce_local", "ce_lite", "kl_local_lite"):
        _close(got_m[key], exp_m[key], 1e-5)
    _close(gx, exp_gx, 1e-5)
    _close(gy, exp_gy, 1e-5)


def test_ops_wrappers_match_plain_versions():
    x = torch.from_numpy(_normal((6, 64), 60))
    sc = torch.from_numpy(1 + _normal((64,), 61))
    assert torch.equal(tops.rmsnorm_op(x, sc), rmsnorm_ref(x, sc))
    q = torch.from_numpy(_normal((1, 2, 9, 8), 62))
    assert torch.equal(tops.flash_attention_op(q, q, q, sliding_window=3),
                       flash_attention_ref(q, q, q, sliding_window=3))


def _call_apply_norm():
    x = torch.from_numpy(_normal((2, 3, 16), 70))
    tlayers.apply_norm({"scale": torch.ones(16)}, x, "rmsnorm")


def _call_apply_attention():
    cfg = get_config("llama3.2-3b").smoke()
    params = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    x = torch.from_numpy(_normal((1, 5, cfg.d_model), 71))
    tattn.apply_attention(params, cfg, x, torch.arange(5)[None],
                          cache="init")


def _call_mutual_losses():
    x, y = (torch.from_numpy(_normal((4, 10), s)) for s in (72, 73))
    tdistill.mutual_losses(x, y, torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("call,kernel", [
    pytest.param(_call_apply_norm, "_rms",
                 id="_call_apply_norm-cuda.rmsnorm"),
    pytest.param(_call_apply_attention, "_flash",
                 id="_call_apply_attention-cuda.flash_attention"),
    pytest.param(_call_mutual_losses, "_kd",
                 id="_call_mutual_losses-cuda.kd_loss")])
def test_model_path_calls_land_under_kernel_annotations(call, kernel,
                                                         monkeypatch):
    """apply_norm, apply_attention's prefill and mutual_losses reach their
    kernels through kernels/ops.py: only its entry points (rmsnorm_op,
    flash_attention_op, kd_loss_op) call the kernel by ops.py's own name
    for it, so a wrapper put in that name's place sees the call."""
    real, seen = getattr(tops, kernel), []

    def spy(*a, **k):
        seen.append(kernel)
        return real(*a, **k)
    monkeypatch.setattr(tops, kernel, spy)
    call()
    assert seen
