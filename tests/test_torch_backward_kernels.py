"""The backward kernels' plain versions and autograd glue in the port,
against the reference on the CPU.

The Pallas rmsnorm and flash kernels have no backward: the JAX package
differentiates its jnp code (``repro.kernels.ref.rmsnorm_ref``,
``repro.models.layers.apply_norm``, ``repro.models.attention
.gqa_attention``). So the port's closed-form plain backwards
(`repro_torch.kernels.ref.*_bwd_ref`), which the CUDA backward kernels are
held against on the card, are held here against ``jax.vjp`` of those
functions, with grouped KV heads, sliding windows and a ragged S. The
autograd Functions that put the CUDA launches under autograd
(`RMSNorm`, `AddRMSNorm`, `FlashAttention`) are driven on CPU tensors with
their launch swapped for the plain forward, so that their saved tensors,
their handling of a missing upstream gradient and their backward wiring
are checked here too.

Tolerance: fp32, atol 1e-5 (rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import rmsnorm_ref as jrmsnorm_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trms

TOL = dict(atol=1e-5, rtol=1e-5)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("N,d", [(8, 64), (33, 256), (5, 777)])
@pytest.mark.parametrize("oracle", ["kernels.ref", "layers.apply_norm"])
def test_rmsnorm_bwd_ref_matches_jax_vjp(N, d, oracle):
    x, sc, dy = _normal((N, d), 1), 1 + 0.1 * _normal((d,), 2), \
        _normal((N, d), 3)
    if oracle == "kernels.ref":
        fn = lambda a, s: jrmsnorm_ref(a, s)
    else:
        fn = lambda a, s: jlayers.apply_norm({"scale": s}, a, "rmsnorm")
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(sc))
    ex, es = vjp(jnp.asarray(dy))
    gx, gs = ref.rmsnorm_bwd_ref(_t(x), _t(sc), _t(dy))
    np.testing.assert_allclose(gx.numpy(), ex, **TOL)
    np.testing.assert_allclose(gs.numpy(), es, **TOL)


@pytest.mark.parametrize("with_gs", [True, False])
@pytest.mark.parametrize("N,d", [(8, 64), (17, 256)])
def test_add_rmsnorm_bwd_ref_matches_jax_vjp(N, d, with_gs):
    """d_s is the gradient of both x and delta of s = x + delta, y =
    apply_norm(s): the upstream g_s plus the norm's backward of g_y."""
    x, delta = _normal((N, d), 4), _normal((N, d), 5)
    sc = 1 + 0.1 * _normal((d,), 6)
    g_s, g_y = _normal((N, d), 7), _normal((N, d), 8)

    def fn(a, b, s):
        out = a + b
        return out, jlayers.apply_norm({"scale": s}, out, "rmsnorm")
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(delta),
                     jnp.asarray(sc))
    ex, ed, es = vjp((jnp.asarray(g_s if with_gs else np.zeros_like(g_s)),
                      jnp.asarray(g_y)))
    np.testing.assert_allclose(ex, ed, **TOL)
    d_s, dscale = ref.add_rmsnorm_bwd_ref(
        _t(x + delta), _t(sc), _t(g_s) if with_gs else None, _t(g_y))
    np.testing.assert_allclose(d_s.numpy(), ex, **TOL)
    np.testing.assert_allclose(dscale.numpy(), es, **TOL)


FLASH_CASES = [(2, 4, 2, 40, 16, 0), (1, 4, 1, 37, 32, 9),
               (2, 2, 2, 64, 16, 16), (1, 6, 3, 23, 8, 0)]


@pytest.mark.parametrize("B,H,KV,S,hd,window", FLASH_CASES)
def test_flash_attention_bwd_ref_matches_gqa_attention_vjp(B, H, KV, S, hd,
                                                           window):
    """dq, dk, dv of the closed form (from the forward's o and lse) against
    jax.vjp of the reference's gqa_attention, with grouped KV heads, a
    sliding window and ragged S; and lse against the masked scores'
    log-sum-exp."""
    q = _normal((B, S, H, hd), 10)
    k, v = _normal((B, S, KV, hd), 11), _normal((B, S, KV, hd), 12)
    do = _normal((B, S, H, hd), 13)
    fn = lambda a, b, c: jattn.gqa_attention(a, b, c, causal=True,
                                             sliding_window=window,
                                             q_chunk=1024)
    o_ref, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    eq, ek, ev = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).transpose(1, 2) for a in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=True,
                                     sliding_window=window, return_lse=True)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), o_ref, **TOL)
    scores = np.einsum("bhqd,bhkd->bhqk", tq.numpy(),
                       np.repeat(tk.numpy(), H // KV, 1)) / np.sqrt(hd)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    scores = np.where(mask, scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    exp_lse = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), exp_lse[..., 0], **TOL)
    dq, dk, dv = ref.flash_attention_bwd_ref(
        tq, tk, tv, o, lse, _t(do).transpose(1, 2), causal=True,
        sliding_window=window)
    for got, exp in ((dq, eq), (dk, ek), (dv, ev)):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), exp, **TOL)


@pytest.fixture
def plain_launches(monkeypatch):
    """The autograd Functions' CUDA launches swapped for the plain forwards,
    so that the Functions run on CPU tensors; their backwards then reach
    the wrappers' CPU path (the plain backwards)."""
    monkeypatch.setattr(trms, "_launch", ref.rmsnorm_ref)
    monkeypatch.setattr(trms, "_launch_add", ref.add_rmsnorm_ref)
    monkeypatch.setattr(
        tflash, "_launch",
        lambda q, k, v, causal, window, with_lse=False: ref.flash_attention_ref(
            q, k, v, causal=causal, sliding_window=window,
            return_lse=with_lse))


@pytest.mark.parametrize("loss_on", ["s_and_y", "y", "s"])
def test_norm_functions_backward_matches_jax(plain_launches, loss_on):
    """RMSNorm and AddRMSNorm under autograd: gradients of x, delta and
    scale equal jax.vjp of the reference's add-then-apply_norm, with a loss
    on s and y, on y alone (s's gradient missing) and on s alone (y's
    missing: nothing reaches the scale)."""
    N, d = 6, 32
    x0, d0 = _normal((N, d), 20), _normal((N, d), 21)
    sc0 = 1 + 0.1 * _normal((d,), 22)
    ws, wy = _normal((N, d), 23), _normal((N, d), 24)

    def jloss(a, b, s):
        out = a + b
        y = jlayers.apply_norm({"scale": s}, out, "rmsnorm")
        return ((loss_on != "y") * jnp.sum(out * ws)
                + (loss_on != "s") * jnp.sum(y * wy))
    exp = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x0),
                                             jnp.asarray(d0),
                                             jnp.asarray(sc0))
    x, delta, sc = (_t(a).requires_grad_(True) for a in (x0, d0, sc0))
    s, y = trms.AddRMSNorm.apply(x, delta, sc, 1e-5)
    loss = {"s_and_y": (s * _t(ws)).sum() + (y * _t(wy)).sum(),
            "y": (y * _t(wy)).sum(), "s": (s * _t(ws)).sum()}[loss_on]
    loss.backward()
    for got, e in zip((x.grad, delta.grad), exp[:2]):
        np.testing.assert_allclose(got.numpy(), e, **TOL)
    if loss_on == "s":
        assert sc.grad is None
    else:
        np.testing.assert_allclose(sc.grad.numpy(), exp[2], **TOL)
    # the plain norm's Function: the same scale gradient through y alone
    x2, sc2 = _t(x0 + d0).requires_grad_(True), _t(sc0).requires_grad_(True)
    (trms.RMSNorm.apply(x2, sc2, 1e-5) * _t(wy)).sum().backward()
    ex2 = jax.grad(lambda a, s: jnp.sum(jlayers.apply_norm(
        {"scale": s}, a, "rmsnorm") * wy), argnums=(0, 1))(
        jnp.asarray(x0 + d0), jnp.asarray(sc0))
    np.testing.assert_allclose(x2.grad.numpy(), ex2[0], **TOL)
    np.testing.assert_allclose(sc2.grad.numpy(), ex2[1], **TOL)


@pytest.mark.parametrize("B,H,KV,S,hd,window", FLASH_CASES[:2])
def test_flash_function_backward_matches_jax(plain_launches, B, H, KV, S, hd,
                                             window):
    """FlashAttention under autograd on the model's transposed views: the
    gradients of the (B, S, N, hd) projections equal jax.vjp of
    gqa_attention."""
    q0 = _normal((B, S, H, hd), 30)
    k0, v0 = _normal((B, S, KV, hd), 31), _normal((B, S, KV, hd), 32)
    w = _normal((B, S, H, hd), 33)
    exp = jax.grad(lambda a, b, c: jnp.sum(jattn.gqa_attention(
        a, b, c, causal=True, sliding_window=window) * w),
        argnums=(0, 1, 2))(jnp.asarray(q0), jnp.asarray(k0), jnp.asarray(v0))
    q, k, v = (_t(a).requires_grad_(True) for a in (q0, k0, v0))
    o = tflash.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), True, window)
    (o.transpose(1, 2) * _t(w)).sum().backward()
    for got, e in zip((q.grad, k.grad, v.grad), exp):
        np.testing.assert_allclose(got.numpy(), e, **TOL)


def test_backward_wrappers_check_their_inputs():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 1, 8, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError):       # o of the wrong shape
        tflash.flash_attention_bwd(q, k, k, k, lse, q)
    with pytest.raises(TypeError):        # lse not float32
        tflash.flash_attention_bwd(q, k, k, q, lse.double(), q)
    with pytest.raises(ValueError):       # dy of another shape than x
        trms.rmsnorm_bwd(torch.zeros((4, 8)), torch.ones(8),
                         torch.zeros((4, 9)))
    with pytest.raises(TypeError):        # mixed dtypes
        trms.add_rmsnorm_bwd(torch.zeros((4, 8)), torch.ones(8),
                             None, torch.zeros((4, 8), dtype=torch.float64))


# The launch shapes of the backward kernels, decided on the host: the norm
# backward's persistent grid and its grid barrier's words, and the flash
# backward's D / lse scratch.

@pytest.mark.parametrize("d,elt,threads,teams", [
    (3072, 2, 128, 4), (256, 2, 32, 16), (3072, 4, 192, 2), (256, 4, 64, 8),
    (777, 2, 128, 4), (777, 4, 128, 4), (8192, 2, 256, 2), (8192, 4, 512, 1),
    (64, 4, 32, 16), (4100, 2, 544, 1)])
def test_norm_bwd_block_follows_the_kernels_rule(d, elt, threads, teams):
    """csrc/rmsnorm.cu's launch_bwd_packs: 16-byte packs when d allows, at
    most 4 a thread (8 single elements), 128 threads while that holds the
    row, rounded up to a multiple of 32; as many rows a block as fit in 512
    threads."""
    assert trms.bwd_threads(d, elt) == threads
    assert trms.bwd_teams(d, elt) == teams


@pytest.mark.parametrize("N,d,elt,sms,blocks", [
    (2048, 3072, 2, 132, 132),     # the training path: 4 rows an SM
    (2048, 256, 2, 132, 128),      # 16 rows a block, one each
    (1000, 3072, 2, 132, 132),     # not a multiple of the grid
    (1000, 256, 2, 132, 63),
    (100, 3072, 2, 132, 25),       # at most one row a team
    (2048, 8192, 4, 132, 132),
    (1, 64, 4, 132, 1)])
def test_norm_bwd_grid(N, d, elt, sms, blocks):
    assert trms.bwd_grid(N, d, elt, sms) == blocks


def test_norm_bwd_barrier_words():
    """The grid barrier's words, made once per device: an arrival count at
    0, which every launch leaves at 0, and a generation number on another
    128-byte line."""
    words = trms._bwd_counters(torch.device("cpu"))
    assert words.dtype == torch.int32 and words.shape == (64,)
    assert not words.any()
    assert trms._bwd_counters(torch.device("cpu")) is words


@pytest.mark.parametrize("S,dtype,shape", [
    (512, torch.bfloat16, (2, 96, 512)), (300, torch.bfloat16, (2, 96, 320)),
    (1, torch.bfloat16, (2, 96, 64)), (300, torch.float32, (96, 300))])
def test_flash_bwd_scratch_shape(S, dtype, shape):
    """fp32: D, (B H, S); bf16: D and lse in log2 units, each (B H, S)
    padded to whole tiles of TILE_ROWS, the rows the wgmma kernels copy."""
    assert tflash.bwd_scratch_shape(4, 24, S, dtype) == shape
