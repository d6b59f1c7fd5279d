"""The port's VLM (qwen2-vl-2b) and audio (musicgen-medium) families against
the reference on the CPU: M-RoPE, the forward, prefill and decode steps,
ServeEngine.generate, loss_and_grads and the train step (plain,
loss-chunked and microbatched, which splits M-RoPE's (3, B, S) positions
on their batch axis), and `token_batches`. Inputs are made from a seed with
numpy; params are made by the reference and carried over through numpy
(repro_torch.convert). The configs are the fp32 smoke cuts: qwen2-vl-2b's
d 256, 4 heads over 2 KV heads, hd 64, M-RoPE sections (16, 8, 8), on
patch embeddings with (t, t // 8, t % 8) positions; musicgen-medium's d
256, 4 heads, layernorm, GELU, 4 codebooks over vocab 512. The params
tree of both is held leaf for leaf in tests/test_torch_transformer.py.

Tolerances: M-RoPE fp32 atol 1e-6, bf16 within one bf16 ulp; model logits
1e-4 (the dense family's, tests/test_torch_transformer.py); training atol
1e-5, rtol 1e-4 with new params held where |g_ref| >= 1e-4
(tests/test_torch_train.py); generated tokens identical, token batches
bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.launch.train import token_batches as jtoken_batches
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.optim import optimizers as jopt
from repro.serve import ServeEngine as JServeEngine
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.train import token_batches
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.optim import optimizers as topt
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train import step as tstep

ARCHS = ("qwen2-vl-2b", "musicgen-medium")
TOL = dict(atol=1e-5, rtol=1e-4)

# the reference's entry points, compiled once per config
_jforward = jax.jit(japi.forward, static_argnums=1)
_jprefill = jax.jit(japi.prefill, static_argnums=1)
_jdecode = jax.jit(japi.decode_step, static_argnums=1)


def _close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


def _inputs(cfg, B, S, seed, labels=False):
    """A numpy batch of `cfg`'s structure: (B, S, d) N(0, 1) embeddings and
    (3, B, S) positions (t, t // 8, t % 8) for the VLM, (B, S, nq) codebook
    tokens for audio; labels of the tokens' shape."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out["positions"] = np.stack([t, t // 8, t % 8])
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S, cfg.n_codebooks)).astype(np.int32)
    if labels:
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        out["labels"] = rng.integers(0, cfg.vocab_size, shape).astype(
            np.int32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            batch.items()}


def _step_inputs(cfg, B, seed):
    """One decode step's numpy batch: a VLM's (B, 1, d) embeddings (decode
    takes its positions from the cache index), an audio model's (B, 1, nq)
    tokens."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (B, 1, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, 1, cfg.n_codebooks)).astype(np.int32)}


@pytest.fixture(scope="module")
def models():
    """arch -> (reference smoke config, port smoke config, reference
    params, port params), each made once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, tcfg = jget_config(arch).smoke(), tget_config(arch).smoke()
            jp = japi.init_model(jax.random.PRNGKey(3), jcfg)
            made[arch] = (jcfg, tcfg, jp,
                          params_from_numpy(jax.device_get(jp), device="cpu"))
        return made[arch]
    return get


# ---------------------------------------------------------------------- #
# M-RoPE
# ---------------------------------------------------------------------- #
def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [24, 1], ids=["prefill", "decode"])
@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((16, 8, 8), 64)])
def test_apply_mrope_matches_reference(sections, hd, S, dtype):
    """Each rotary dimension takes its section's position stream; three
    streams drawn apart, so a section read from the wrong stream shows."""
    rng = np.random.default_rng(hd + S)
    x = rng.standard_normal((2, S, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, S)).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    exp = np.asarray(jlayers.apply_rope(jx, jnp.asarray(pos), 1e6, sections)
                     .astype(jnp.float32))
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, atol=1e-6, rtol=0)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(exp)))
        assert np.all(np.abs(got - exp) <= ulp)


def test_apply_mrope_refuses_flat_positions():
    with pytest.raises(ValueError, match="3, B, S"):
        tlayers.apply_rope(torch.zeros(1, 4, 2, 64),
                           torch.zeros(1, 4, dtype=torch.int32), 1e6,
                           (16, 8, 8))


# ---------------------------------------------------------------------- #
# the model and serving
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    batch = _inputs(jcfg, 2, 24, 5)
    exp, _ = _jforward(jp, jcfg, _j(batch))
    got, aux = tapi.forward(tp, tcfg, _t(batch))
    shape = (2, 24) + ((4,) if jcfg.n_codebooks else ()) + (jcfg.vocab_size,)
    assert tuple(got.shape) == shape == exp.shape
    assert got.dtype == torch.float32 and aux == {}
    _close(got, exp, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(models, arch):
    """Prefill logits and cache, then 4 decode steps fed the same inputs
    (the VLM's decode positions, (3, B, 1), come from the cache index)."""
    jcfg, tcfg, jp, tp = models(arch)
    B, S, L = 2, 10, 16
    batch = _inputs(jcfg, B, S, 6)
    jl, jc = _jprefill(jp, jcfg, _j(batch))
    tl, tc = tapi.prefill(tp, tcfg, _t(batch))
    assert tl.shape == jl.shape
    _close(tl, jl, 1e-4)
    jcache = jax.tree_util.tree_map(
        lambda big, small: jax.lax.dynamic_update_slice(big, small, (0,) * 5),
        japi.make_decode_cache(jcfg, B, L), jc)
    tcache = tapi.make_decode_cache(tcfg, B, L, device="cpu")
    for key in ("k", "v"):
        _close(tc["blocks"][key], jc["blocks"][key], 1e-4)
        tcache["blocks"][key][:, :, :S] = tc["blocks"][key]
    for i in range(4):
        step = _step_inputs(jcfg, B, 7 + i)
        jl, jcache = _jdecode(jp, jcfg, _j(step), jcache, S + i)
        tl, tcache = tapi.decode_step(tp, tcfg, _t(step), tcache,
                                      torch.tensor(S + i))
        assert tl.shape == jl.shape
        _close(tl, jl, 1e-4)
        for key in ("k", "v"):
            _close(tcache["blocks"][key], jcache["blocks"][key], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(models, arch):
    """Greedy tokens equal: (B, n) for the VLM, which feeds each step the
    embedding rows of its argmax tokens; (B, n, nq) for audio."""
    jcfg, tcfg, jp, tp = models(arch)
    batch = _inputs(jcfg, 3, 12, 8)
    exp = JServeEngine(jcfg, jp, max_len=32).generate(_j(batch), n_new=8)
    got = TServeEngine(tcfg, tp, max_len=32, device="cpu").generate(
        batch, n_new=8)
    shape = (3, 8) + ((4,) if jcfg.n_codebooks else ())
    assert got.shape == shape == np.asarray(exp).shape
    np.testing.assert_array_equal(got, np.asarray(exp))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_logits_are_the_decode_step_loop(models, arch):
    """The engine's static decode step (what a CUDA graph captures on the
    card) equals a plain loop of make_decode_step on decode_batch's inputs,
    bit for bit."""
    from repro_torch.serve import decode_batch, make_decode_step
    _, tcfg, _, tp = models(arch)
    batch = _t(_inputs(tcfg, 2, 6, 9))
    eng = TServeEngine(tcfg, tp, max_len=32, device="cpu")
    got, logits = eng.generate(batch, n_new=6, return_logits=True)
    nq = (4,) if tcfg.n_codebooks else ()
    assert logits.shape == (2, 6) + nq + (tcfg.vocab_size,)
    step = make_decode_step(tcfg)
    with torch.no_grad():
        first, pre = tapi.prefill(tp, tcfg, batch)
        cache = tapi.make_decode_cache(tcfg, 2, 32, device="cpu")
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :6] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        for i in range(6):
            nxt, lg, cache = step(tp, decode_batch(tcfg, tp, nxt[:, None]),
                                  cache, torch.tensor(6 + i))
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.numpy(), got[:, i])


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _halves(batch):
    """The reference's two microbatches, split by hand: the batch axis, and
    axis 1 of the (3, B, S) positions."""
    return [{k: (v[:, i * 2:(i + 1) * 2] if k == "positions"
                 else v[i * 2:(i + 1) * 2]) for k, v in batch.items()}
            for i in range(2)]


@pytest.fixture(scope="module")
def train_setups():
    """arch -> (reference local, lite, port local, lite, reference params):
    the fp32 smoke cut and its LiteModel, as launch/train.py --smoke cuts
    them."""
    made = {}

    def get(arch):
        if arch not in made:
            cfgs = []
            for get_cfg, dt in ((jget_config, jnp.float32),
                                (tget_config, torch.float32)):
                cfg = get_cfg(arch).smoke()
                cfgs += [cfg, dataclasses.replace(cfg.lite(), dtype=dt,
                                                  remat=False,
                                                  scan_layers=False)]
            jstate = jstep.make_train_state(jax.random.PRNGKey(0), cfgs[0],
                                            cfgs[1])
            made[arch] = (*cfgs, jax.device_get(jstate["params"]))
        return made[arch]
    return get


@pytest.mark.parametrize("mode", ["plain", "loss_chunk", "microbatch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(train_setups, arch, mode):
    """loss_and_grads (the VLM's token embedding, which training never
    reads, gets exactly zero gradient on both sides) and one AdamW step:
    metrics, grad norm and the new params."""
    jcfg, jlite, tcfg_, tlite, jparams = train_setups(arch)
    kw = {"plain": {}, "microbatch": {"microbatch": 2},
          "loss_chunk": {"loss_chunk": 8}}[mode]
    jt, tt = jstep.TrainStepConfig(**kw), tstep.TrainStepConfig(**kw)
    batch = _inputs(jcfg, 4, 16, 10, labels=True)

    grad = jax.jit(jax.grad(
        lambda p, b: jstep._losses(p, jcfg, jlite, jt, b)[0]))

    def jgrad(b):
        return grad(jparams, _j(b))

    if mode == "microbatch":
        gs = [jgrad(b) for b in _halves(batch)]
        jgrads = jax.tree_util.tree_map(lambda a, b: a / 2 + b / 2, *gs)
    else:
        jgrads = jgrad(batch)
    jgrads = jax.device_get(jgrads)
    jnew, jm = jax.jit(jstep.make_hapfl_train_step(jcfg, jlite, jt))(
        {"params": jparams, "opt": jopt.adamw(jt.lr).init(jparams)},
        _j(batch))
    jnew = jax.device_get(jnew["params"])

    params = params_from_numpy(jparams, device="cpu")
    if mode != "microbatch":
        _, grads = tstep.loss_and_grads(params, tcfg_, tlite, tt, _t(batch))
        for path in _paths(grads):
            np.testing.assert_allclose(_at(grads, path).numpy(),
                                       _at(jgrads, path), **TOL,
                                       err_msg=str(path))
        if jcfg.input_mode == "embeddings":
            for m in ("local", "lite"):
                assert not grads[m]["io"]["embed"].any()
                assert not np.any(jgrads[m]["io"]["embed"])

    state = {"params": params, "opt": topt.adamw(tt.lr).init(params)}
    state, tm = tstep.make_hapfl_train_step(tcfg_, tlite, tt)(state,
                                                              _t(batch))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(tm["grad_norm"]),
        float(np.sqrt(sum(np.sum(np.square(g))
                          for g in jax.tree_util.tree_leaves(jgrads)))),
        **TOL)
    moved = 0
    for path in _paths(jnew):
        got = _at(state["params"], path).numpy()
        mask = np.abs(_at(jgrads, path)) >= 1e-4
        np.testing.assert_allclose(got[mask], _at(jnew, path)[mask], **TOL,
                                   err_msg=str(path))
        moved += int(mask.sum())
    assert moved > 1000


def test_token_batches_for_codebooks_match_reference():
    """musicgen's (B, S, nq) batches, codebook q the stream rolled by q,
    bitwise the reference's."""
    cfg = tget_config("musicgen-medium").smoke()
    jcfg = jget_config("musicgen-medium").smoke()
    got = list(token_batches(cfg, 2, 16, 3, 4, device="cpu"))
    exp = list(jtoken_batches(jcfg, 2, 16, 3, 4))
    assert len(got) == len(exp) == 3
    for a, b in zip(got, exp):
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].shape == (2, 16, 4)
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_token_batches_for_embeddings_have_the_reference_structure():
    """The VLM's batches: the reference's keys, shapes and dtypes, and its
    (3, B, S) positions bitwise; the embeddings and labels come from a torch
    generator seeded by the step (the reference's jax.random draws cannot
    be reproduced), so they are held to be the same for the same step and
    to differ between steps."""
    cfg = tget_config("qwen2-vl-2b").smoke()
    jcfg = jget_config("qwen2-vl-2b").smoke()
    got = list(token_batches(cfg, 2, 16, 2, device="cpu"))
    exp = list(jtoken_batches(jcfg, 2, 16, 2))
    again = next(token_batches(cfg, 2, 16, 1, device="cpu"))
    for a, b in zip(got, exp):
        assert set(a) == set(b) == {"embeddings", "positions", "labels"}
        for k in a:
            assert tuple(a[k].shape) == b[k].shape
        assert a["embeddings"].dtype == torch.float32
        np.testing.assert_array_equal(a["positions"].numpy(),
                                      np.asarray(b["positions"]))
    for k in ("embeddings", "labels"):
        assert torch.equal(again[k], got[0][k])
        assert not torch.equal(got[0][k], got[1][k])
