"""Head dim 112 in the port, against the reference on the CPU: zamba2-7b's
shared attention block runs at d 3584 over 32 heads, hd 112, which the
flash kernels take on CUDA since they pad it to hd 128's tiles (their CPU
path is the plain version).

- The port's plain flash attention (`repro_torch.kernels.ref`, what the
  wrapper runs on CPU tensors and what the CUDA kernels are held against
  on a card) against the Pallas kernel in interpret mode, and its closed
  form backward and the `FlashAttention` autograd Function against
  ``jax.vjp`` of the reference's ``gqa_attention``: hd 112, S 256 (the
  Pallas kernel needs S to divide into its blocks), fp32 and bf16, causal
  with and without a sliding window, H = KV and a group of 2.
- zamba2-7b cut to d 224 over 2 heads (hd 112) against the reference:
  forward, prefill (the last logits and every cache leaf), decode steps
  from the merged cache, `generate`, and the train step with its
  pure-Mamba2 LiteModel. Two cuts: 2 layers (one segment of 2 Mamba2
  blocks and the shared block, as chip_smoke.py's phase 5i holds it card
  vs CPU) and 5 layers with shared_attn_every 2 (two segments, so the
  shared block's stacked (2, ...) KV cache, and a Mamba2 tail).

Inputs are numpy from a seed; model params are the reference's, carried
over through numpy (`repro_torch.convert`). Tolerances: fp32 atol and rtol
1e-5 for the attention functions (tests/test_torch_backward_kernels.py's);
bf16 2e-2 (tests/test_kernels.py's), the port's plain version computing
in fp32 from bf16 inputs and rounding once, the reference's rounding its
probabilities; models 1e-4 (tests/test_torch_ssm.py's: projections and
recurrent products rounded in other orders than XLA's), cache leaves at
atol 1e-4 x max(1, max|leaf|); training metrics and gradients atol 1e-5,
rtol 1e-4, new params where |g_ref| >= 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import api as japi
from repro.models import attention as jattn
from repro.optim import optimizers as jopt
from repro.serve import ServeEngine as JServeEngine
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as topt
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train import step as tstep

HD = 112
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)

# name -> overrides of zamba2-7b's smoke cut: d 224 over 2 heads, hd 112
CUTS = {"hd112": {},
        "hd112_tail": {"n_layers": 5, "shared_attn_every": 2}}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, exp, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), **tol,
                               err_msg=what)


def test_hd112_is_an_instantiated_head_dim():
    """The CUDA wrapper takes hd 112 (64 and 128 as before); hd 112 comes
    from zamba2-7b's own config."""
    cfg = tget_config("zamba2-7b")
    assert cfg.resolved_head_dim == HD
    assert tflash.HEAD_DIMS == (64, HD, 128)


# ---------------------------------------------------------------------- #
# flash attention at hd 112
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_pallas_at_hd112(window, dtype):
    """H = KV (the Pallas kernel has no groups), causal, S 256 in blocks of
    64, through the wrapper's CPU path."""
    B, H, S = 1, 2, 256
    q, k, v = (_normal((B, H, S, HD), s) for s in (20, 21, 22))
    exp = pallas_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                       causal=True, sliding_window=window, block_q=64,
                       block_k=64, interpret=True)
    tdt = getattr(torch, dtype)
    got = tflash.flash_attention(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)),
                                 causal=True, sliding_window=window)
    assert got.dtype == tdt and got.shape == (B, H, S, HD)
    _close(got, exp, TOL[dtype])


@pytest.mark.parametrize("H,KV,window", [(2, 2, 0), (4, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_ref_matches_jax_vjp_at_hd112(H, KV, window, dtype):
    """The closed-form backward (from the forward's o and lse) against
    jax.vjp of the reference's gqa_attention in fp32 on the same (dtype-
    rounded) inputs; the forward's o too."""
    B, S = 1, 256
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(_normal((B, S, H, HD), 23)).to(tdt)
    k = torch.from_numpy(_normal((B, S, KV, HD), 24)).to(tdt)
    v = torch.from_numpy(_normal((B, S, KV, HD), 25)).to(tdt)
    do = torch.from_numpy(_normal((B, S, H, HD), 26)).to(tdt)
    fn = lambda a, b, c: jattn.gqa_attention(a, b, c, causal=True,
                                             sliding_window=window)
    o_ref, vjp = jax.vjp(fn, *(jnp.asarray(t.float().numpy())
                               for t in (q, k, v)))
    exp = vjp(jnp.asarray(do.float().numpy()))
    tq, tk, tv = (t.transpose(1, 2) for t in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=True,
                                     sliding_window=window, return_lse=True)
    _close(o.transpose(1, 2), o_ref, TOL[dtype], "o")
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, do.transpose(1, 2),
                                      causal=True, sliding_window=window)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert g.dtype == tdt
        _close(g.transpose(1, 2), e, TOL[dtype], name)


def test_flash_function_backward_matches_jax_at_hd112(monkeypatch):
    """FlashAttention under autograd on the model's transposed views, its
    launch swapped for the plain forward (as a CPU tensor cannot reach the
    kernel): the gradients of the (B, S, N, hd) projections equal jax.grad
    of gqa_attention, fp32, a group of 2 and a window."""
    monkeypatch.setattr(
        tflash, "_launch",
        lambda q, k, v, causal, window, with_lse=False: ref.flash_attention_ref(
            q, k, v, causal=causal, sliding_window=window,
            return_lse=with_lse))
    B, S, H, KV, window = 2, 256, 4, 2, 48
    q0 = _normal((B, S, H, HD), 27)
    k0, v0 = _normal((B, S, KV, HD), 28), _normal((B, S, KV, HD), 29)
    w = _normal((B, S, H, HD), 30)
    exp = jax.grad(lambda a, b, c: jnp.sum(jattn.gqa_attention(
        a, b, c, causal=True, sliding_window=window) * w),
        argnums=(0, 1, 2))(jnp.asarray(q0), jnp.asarray(k0), jnp.asarray(v0))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q0, k0, v0))
    o = tflash.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), True, window)
    (o.transpose(1, 2) * torch.from_numpy(w)).sum().backward()
    for name, got, e in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                            exp):
        _close(got, e, TOL["float32"], name)


# ---------------------------------------------------------------------- #
# zamba2-7b at hd 112
# ---------------------------------------------------------------------- #
_jforward = jax.jit(japi.forward, static_argnums=1)
_jprefill = jax.jit(japi.prefill, static_argnums=1)
_jdecode = jax.jit(japi.decode_step, static_argnums=1)


def _cfg(get_cfg, name):
    return dataclasses.replace(get_cfg("zamba2-7b").smoke(), d_model=224,
                               n_heads=2, n_kv_heads=2, head_dim=HD,
                               **CUTS[name])


@pytest.fixture(scope="module")
def models():
    """name -> (reference config, port config, reference params, port
    params), each made once for the module."""
    made = {}

    def get(name):
        if name not in made:
            jcfg, tcfg = _cfg(jget_config, name), _cfg(tget_config, name)
            assert jcfg.resolved_head_dim == tcfg.resolved_head_dim == HD
            jp = japi.init_model(jax.random.PRNGKey(4), jcfg)
            made[name] = (jcfg, tcfg, jp,
                          params_from_numpy(jax.device_get(jp), device="cpu"))
        return made[name]
    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_scaled(got, exp, what=""):
    exp = np.asarray(exp, np.float32)
    _close(got, exp, dict(rtol=1e-4, atol=1e-4 * max(1.0, np.abs(exp).max())),
           what)


@pytest.mark.parametrize("name", list(CUTS))
def test_zamba2_hd112_forward_matches_reference(models, name):
    jcfg, tcfg, jp, tp = models(name)
    tok = _tokens(jcfg, 2, 256, 31)
    exp, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, aux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    assert tuple(got.shape) == exp.shape == (2, 256, jcfg.vocab_size)
    assert aux == {}
    _close(got, exp, MODEL_TOL)


@pytest.mark.parametrize("name", list(CUTS))
def test_zamba2_hd112_prefill_and_decode_steps_match_reference(models, name):
    """Prefill over 256 tokens: the last logits and every cache leaf (the
    shared block's (n_seg, B, S, 2, 112) KV cache and the Mamba2 states);
    then 4 decode steps from the merged cache, their logits and every
    cache leaf after each."""
    jcfg, tcfg, jp, tp = models(name)
    B, S, L = 2, 256, 264
    tok = _tokens(jcfg, B, S + 4, 32)
    jl, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :S])})
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok[:, :S])})
    _close(tl, jl, MODEL_TOL)
    n_seg = tcfg.n_layers // tcfg.shared_attn_every
    assert tuple(tc["shared"]["k"].shape) == (n_seg, B, S, 2, HD)
    assert sorted(_paths(tc)) == sorted(
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jc)[0])
    for path in _paths(tc):
        _close_scaled(_at(tc, path), _at(jc, path), what=f"prefill {path}")

    def jmerge(big, small):
        if big.shape != small.shape:
            return jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim)
        return small
    jcache = jax.tree_util.tree_map(jmerge,
                                    japi.make_decode_cache(jcfg, B, L), jc)
    tcache = tapi.make_decode_cache(tcfg, B, L, device="cpu")
    for path in _paths(tcache):
        big, small = _at(tcache, path), _at(tc, path)
        if big.shape != small.shape:
            big[tuple(slice(0, s) for s in small.shape)] = small
        else:
            _at(tcache, path[:-1])[path[-1]] = small.clone()
    for i in range(4):
        step = tok[:, S + i:S + i + 1]
        jl, jcache = _jdecode(jp, jcfg, {"tokens": jnp.asarray(step)},
                              jcache, S + i)
        tl, out = tapi.decode_step(tp, tcfg,
                                   {"tokens": torch.from_numpy(step)},
                                   tcache, torch.tensor(S + i))
        assert out is tcache
        _close(tl, jl, MODEL_TOL, f"decode step {i}")
        for path in _paths(tcache):
            _close_scaled(_at(tcache, path), _at(jcache, path),
                          what=f"step {i} {path}")


@pytest.mark.parametrize("name", list(CUTS))
def test_zamba2_hd112_generate_matches_reference(models, name):
    """Greedy tokens equal the reference engine's (both keep only the
    shared block's KV of the prompt, ROADMAP §3)."""
    jcfg, tcfg, jp, tp = models(name)
    tok = _tokens(jcfg, 3, 12, 33)
    exp = JServeEngine(jcfg, jp, max_len=32).generate(
        {"tokens": jnp.asarray(tok)}, n_new=8)
    got = TServeEngine(tcfg, tp, max_len=32, device="cpu").generate(
        {"tokens": tok}, n_new=8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(exp))


@pytest.fixture(scope="module")
def train_setup():
    """(reference local, lite, port local, lite, reference params) of the
    2-segment hd-112 cut with its pure-Mamba2 LiteModel (2 blocks, d 256),
    fp32, remat off in the LiteModel as launch/train.py --smoke cuts it."""
    cfgs = []
    for get_cfg, dt in ((jget_config, jnp.float32),
                        (tget_config, torch.float32)):
        cfg = _cfg(get_cfg, "hd112_tail")
        cfgs += [cfg, dataclasses.replace(cfg.lite(), dtype=dt, remat=False,
                                          scan_layers=False)]
    jstate = jstep.make_train_state(jax.random.PRNGKey(1), cfgs[0], cfgs[1])
    return (*cfgs, jax.device_get(jstate["params"]))


def test_zamba2_hd112_train_step_matches_reference(train_setup):
    """loss_and_grads and one AdamW step on 4 x 16 tokens: every gradient
    (the shared block's summed over its two invocations), the metrics and
    the new params."""
    jcfg, jlite, tcfg, tlite, jparams = train_setup
    jt, tt = jstep.TrainStepConfig(), tstep.TrainStepConfig()
    rng = np.random.default_rng(34)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jgrads = jax.device_get(jax.jit(jax.grad(
        lambda p, b: jstep._losses(p, jcfg, jlite, jt, b)[0]))(jparams, jb))
    jnew, jm = jax.jit(jstep.make_hapfl_train_step(jcfg, jlite, jt))(
        {"params": jparams, "opt": jopt.adamw(jt.lr).init(jparams)}, jb)
    jnew = jax.device_get(jnew["params"])

    params = params_from_numpy(jparams, device="cpu")
    _, grads = tstep.loss_and_grads(params, tcfg, tlite, tt, tb)
    assert sorted(_paths(grads)) == sorted(_paths(jgrads))
    assert float(grads["local"]["shared"]["attn"]["wq"].abs().max()) > 0
    for path in _paths(grads):
        _close(_at(grads, path), _at(jgrads, path), TRAIN_TOL, str(path))
    state = {"params": params, "opt": topt.adamw(tt.lr).init(params)}
    state, tm = tstep.make_hapfl_train_step(tcfg, tlite, tt)(state, tb)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TRAIN_TOL,
                                   err_msg=k)
    moved = 0
    for path in _paths(jnew):
        got = _at(state["params"], path).numpy()
        mask = np.abs(_at(jgrads, path)) >= 1e-4
        np.testing.assert_allclose(got[mask], _at(jnew, path)[mask],
                                   **TRAIN_TOL, err_msg=str(path))
        moved += int(mask.sum())
    assert moved > 1000
