"""The port's SSM family (models/ssm.py: Mamba2 SSD, mLSTM, sLSTM) and its
three layouts (xLSTM groups and tail, the zamba2 hybrid, pure Mamba2)
against the reference on the CPU: each block's function at L = 256 (two
chunks of 128 carry state), and the vjps of both chunk scans; forward,
prefill (the last logits and every cache leaf) and decode steps through
the API, as tests/test_decode.py::test_prefill_decode_consistency holds
them (not through `generate`, which drops the prompt's recurrent state on
both sides); the engine's graph-free decode step against a
make_decode_step loop; `generate` against the reference's, its caches
paired by key; loss_and_grads and the train step (plain, loss_chunk and microbatch).

Inputs are made from a seed with numpy; params are made by the reference
and carried over through numpy (repro_torch.convert). The configs are fp32
smoke cuts: xlstm-1.3b's (d 256, 4 heads, one mLSTM and one sLSTM block)
and a 5-layer cut with slstm_every 2 (two groups and an mLSTM tail);
zamba2-7b's (d 256, two Mamba2 blocks and the shared attention block, hd
64) and a 5-layer cut with shared_attn_every 2 (two segments and a tail);
the pure-Mamba2 LiteModel of zamba2's smoke cut (2 Mamba2 blocks).

Tolerances: atol and rtol 1e-4 in fp32 (the projections and the
recurrent products are rounded in other orders than XLA's). Two kinds of
values are sums over many positions whose size grows with them, and hold
an absolute atol of 1e-4 times the largest |value| of their tensor (rtol
1e-4): the cache leaves after a prompt (an sLSTM's normaliser and
stabiliser grow with the prompt, rounded at every step) and the mLSTM's
log forget gate gradient. The engine's decode step against the loop
bitwise, generated tokens identical; training metrics and new params atol 1e-5, rtol 1e-4, the new
params held where |g_ref| >= 1e-4 (tests/test_torch_train.py's rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.optim import optimizers as jopt
from repro.serve import ServeEngine as JServeEngine
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import ssm as tssm
from repro_torch.optim import optimizers as topt
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train import step as tstep
from repro_torch.utils.pytree import tree_leaves

TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)

# name -> (arch, overrides of its smoke cut, LiteModel of it)
CUTS = {
    "xlstm": ("xlstm-1.3b", {}, False),
    "xlstm_tail": ("xlstm-1.3b", {"n_layers": 5, "slstm_every": 2}, False),
    "zamba2": ("zamba2-7b", {}, False),
    "zamba2_tail": ("zamba2-7b", {"n_layers": 5, "shared_attn_every": 2},
                    False),
    "mamba2_lite": ("zamba2-7b", {}, True),
}

_jforward = jax.jit(japi.forward, static_argnums=1)
_jprefill = jax.jit(japi.prefill, static_argnums=1)
_jdecode = jax.jit(japi.decode_step, static_argnums=1)


def _cfg(get_cfg, name):
    arch, kw, lite = CUTS[name]
    cfg = dataclasses.replace(get_cfg(arch).smoke(), **kw)
    return cfg.lite() if lite else cfg


@pytest.fixture(scope="module")
def models():
    """name -> (reference config, port config, reference params, port
    params), each made once for the module."""
    made = {}

    def get(name):
        if name not in made:
            jcfg, tcfg = _cfg(jget_config, name), _cfg(tget_config, name)
            jp = japi.init_model(jax.random.PRNGKey(3), jcfg)
            made[name] = (jcfg, tcfg, jp,
                          params_from_numpy(jax.device_get(jp), device="cpu"))
        return made[name]
    return get


def _close(got, exp, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(exp, np.float32), **tol,
                               err_msg=what)


def _close_scaled(got, exp, what=""):
    """rtol 1e-4 and atol 1e-4 x max(1, max|exp|): a sum over many
    positions, rounded along the way in proportion to its size."""
    exp = np.asarray(exp, np.float32)
    _close(got, exp, dict(rtol=1e-4, atol=1e-4 * max(1.0, np.abs(exp).max())),
           what)


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


# ---------------------------------------------------------------------- #
# the blocks' functions
# ---------------------------------------------------------------------- #
def _rng_f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ssd_inputs(seed, B=2, L=256, H=4, P=16, n=8):
    rng = np.random.default_rng(seed)
    xh, Bm, Cm = _rng_f32(rng, B, L, H, P), _rng_f32(rng, B, L, n), \
        _rng_f32(rng, B, L, n)
    dt = np.log1p(np.exp(_rng_f32(rng, B, L, H) - 3.0)).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    return xh, Bm, Cm, dt, A


def _mlstm_inputs(seed, B=2, L=256, H=4, Pk=8, P=16):
    rng = np.random.default_rng(seed)
    q, k = _rng_f32(rng, B, L, H, Pk), _rng_f32(rng, B, L, H, Pk)
    v = _rng_f32(rng, B, L, H, P)
    li = _rng_f32(rng, B, L, H)
    lf = -np.log1p(np.exp(-(_rng_f32(rng, B, L, H) + 3.0))).astype(
        np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """The depthwise conv over 256 positions, from zeros and from a carried
    (B, w-1, C) window: its silu output and its new window."""
    rng = np.random.default_rng(1)
    x, w, b = _rng_f32(rng, 2, 256, 40), _rng_f32(rng, 4, 40, scale=0.1), \
        _rng_f32(rng, 40)
    state = _rng_f32(rng, 2, 3, 40) if with_state else None
    ey, es = jssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                               None if state is None else jnp.asarray(state))
    gy, gs = tssm._causal_conv(*map(torch.from_numpy, (x, w, b)),
                               None if state is None
                               else torch.from_numpy(state))
    _close(gy, ey)
    assert torch.equal(gs, torch.from_numpy(np.array(es)))


def test_ssd_chunk_scan_matches_reference():
    """Mamba2's chunkwise SSD over two chunks: y and the final state."""
    ins = _ssd_inputs(2)
    ey, eh = jssm._ssd_chunk_scan(*map(jnp.asarray, ins))
    gy, gh = tssm._ssd_chunk_scan(*map(torch.from_numpy, ins))
    assert gy.shape == ey.shape and gh.shape == eh.shape == (2, 4, 8, 16)
    _close(gy, ey)
    _close(gh, eh)


def test_mlstm_chunk_scan_matches_reference():
    """The mLSTM's chunkwise scan over two chunks: h and the final (C, n,
    m) with its log-space stabiliser."""
    ins = _mlstm_inputs(3)
    eh, estate = jssm._mlstm_chunk_scan(*map(jnp.asarray, ins))
    gh, gstate = tssm._mlstm_chunk_scan(*map(torch.from_numpy, ins))
    _close(gh, eh)
    for g, e in zip(gstate, estate):
        assert g.shape == e.shape
        _close(g, e)


@pytest.mark.parametrize("scan", ["ssd", "mlstm"])
def test_chunk_scan_vjps_match_reference_and_are_finite(scan):
    """Both scans' gradients against jax.vjp on the same cotangents: the
    masked log-weights (-inf before the exp) pass zero, not NaN. The
    mLSTM's log forget gate at t enters every later position's cumulative
    sum, so its gradient is a sum of terms up to max|g| that cancel (at t
    = 0 to exactly 0, the gate multiplying the empty initial state): it is
    held as `_close_scaled` holds it, every other gradient at atol and rtol
    1e-4."""
    if scan == "ssd":
        ins, jfn, tfn = _ssd_inputs(4), jssm._ssd_chunk_scan, \
            tssm._ssd_chunk_scan
    else:
        ins, jfn, tfn = _mlstm_inputs(5), jssm._mlstm_chunk_scan, \
            tssm._mlstm_chunk_scan
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    rng = np.random.default_rng(6)
    cts = jax.tree_util.tree_map(
        lambda t: jnp.asarray(_rng_f32(rng, *t.shape)), out)
    egrads = vjp(cts)
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tout = tfn(*tins)
    torch.autograd.backward(
        tree_leaves(tout),
        [torch.from_numpy(np.asarray(c)) for c in
         jax.tree_util.tree_leaves(cts)])
    for i, (t, e) in enumerate(zip(tins, egrads)):
        got, e = t.grad.numpy(), np.asarray(e)
        assert np.isfinite(got).all() and np.isfinite(e).all(), i
        if scan == "mlstm" and i == 4:                       # lf
            _close_scaled(got, e, what=f"input {i}")
        else:
            _close(got, e, what=f"input {i}")


@pytest.mark.parametrize("state", ["init", "carried"])
def test_apply_slstm_matches_reference(state):
    """The sLSTM's time loop over 256 steps (one bmm a step against r laid
    out (H, dh, 4 dh)): y and its final (h, c, n, m), from zeros, and from
    a given state, which the port writes back in place."""
    jcfg, tcfg = jget_config("xlstm-1.3b").smoke(), \
        tget_config("xlstm-1.3b").smoke()
    jp = jssm.init_slstm(jax.random.PRNGKey(7), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(8)
    x = _rng_f32(rng, 2, 256, jcfg.d_model)
    if state == "init":
        jcache, tcache = "init", "init"
    else:
        st = {k: _rng_f32(rng, 2, jcfg.d_model) for k in "hcnm"}
        st["n"] = np.abs(st["n"]) + 1.0
        jcache = {k: jnp.asarray(v) for k, v in st.items()}
        tcache = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ey, ec = jssm.apply_slstm(jp, jcfg, jnp.asarray(x), jcache)
    gy, gc = tssm.apply_slstm(tp, tcfg, torch.from_numpy(x), tcache)
    _close(gy, ey)
    for k in "hcnm":
        _close(gc[k], ec[k], what=k)
    if state == "carried":
        assert gc is tcache


# ---------------------------------------------------------------------- #
# the model through the API
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CUTS))
def test_forward_matches_reference(models, name):
    jcfg, tcfg, jp, tp = models(name)
    tok = _tokens(jcfg, 2, 256, 10)
    exp, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, aux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    assert tuple(got.shape) == exp.shape == (2, 256, jcfg.vocab_size)
    assert aux == {}
    _close(got, exp)


def _merge(big, small):
    """tests/test_decode.py's merge: a prefill leaf of another shape
    written at the origin of the decode leaf, one of the same shape taken
    whole (where `generate` leaves it zero)."""
    if big.shape != small.shape:
        big[tuple(slice(0, s) for s in small.shape)] = small
        return big
    return small.clone()


@pytest.mark.parametrize("name", list(CUTS))
def test_prefill_and_decode_steps_match_reference(models, name):
    """Prefill over 256 tokens: the last logits and every cache leaf (KV
    and recurrent states, the reference's keys; `_close_scaled`); then 4
    decode steps from the merged cache, their logits and every cache leaf
    after each."""
    jcfg, tcfg, jp, tp = models(name)
    B, S, L = 2, 256, 264
    tok = _tokens(jcfg, B, S + 4, 11)
    jl, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :S])})
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok[:, :S])})
    assert tl.shape == jl.shape
    _close(tl, jl)
    assert _paths(tc) and sorted(_paths(tc)) == sorted(
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jc)[0])
    for path in _paths(tc):
        assert _at(tc, path).dtype == torch.float32
        _close_scaled(_at(tc, path), _at(jc, path), what=f"prefill {path}")

    def jmerge(big, small):
        if big.shape != small.shape:
            return jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim)
        return small
    jcache = jax.tree_util.tree_map(jmerge,
                                    japi.make_decode_cache(jcfg, B, L), jc)
    tcache = tapi.make_decode_cache(tcfg, B, L, device="cpu")
    for path in _paths(tcache):
        merged = _merge(_at(tcache, path), _at(tc, path))
        _at(tcache, path[:-1])[path[-1]] = merged
    for i in range(4):
        step = {"tokens": tok[:, S + i:S + i + 1]}
        jl, jcache = _jdecode(jp, jcfg, {"tokens": jnp.asarray(step[
            "tokens"])}, jcache, S + i)
        tl, out = tapi.decode_step(tp, tcfg,
                                   {"tokens": torch.from_numpy(step[
                                       "tokens"])},
                                   tcache, torch.tensor(S + i))
        assert out is tcache
        _close(tl, jl, what=f"decode step {i}")
        for path in _paths(tcache):
            _close_scaled(_at(tcache, path), _at(jcache, path),
                          what=f"step {i} {path}")


@pytest.mark.parametrize("name", ["xlstm_tail", "zamba2_tail",
                                  "mamba2_lite"])
def test_engine_decode_step_is_the_decode_step_loop(models, name):
    """The engine's static decode step (what a CUDA graph captures on the
    card, here run eagerly on the same buffers) equals a plain loop of
    make_decode_step from the cache `generate` sets up, bit for bit: its
    in-place state updates carry from step to step as the loop's do."""
    from repro_torch.serve import make_decode_step
    _, tcfg, _, tp = models(name)
    tok = torch.from_numpy(_tokens(tcfg, 2, 8, 12))
    eng = TServeEngine(tcfg, tp, max_len=32, device="cpu")
    got, logits = eng.generate({"tokens": tok}, n_new=6, return_logits=True)
    assert logits.shape == (2, 6, tcfg.vocab_size)
    step = make_decode_step(tcfg)
    with torch.no_grad():
        first, pre = tapi.prefill(tp, tcfg, {"tokens": tok})
        cache = tapi.make_decode_cache(tcfg, 2, 32, device="cpu")
        for path in _paths(cache):     # generate's pairing: KV only
            big, small = _at(cache, path), _at(pre, path)
            if big.shape != small.shape:
                big[tuple(slice(0, s) for s in small.shape)] = small
        nxt = first[:, -1].argmax(-1)
        for i in range(6):
            nxt, lg, cache = step(tp, {"tokens": nxt[:, None]}, cache,
                                  torch.tensor(8 + i))
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.numpy(), got[:, i])
    # the engine's buffers hold the loop's final state, bit for bit
    st = eng.decode_step_for(2).cache
    for path in _paths(cache):
        assert torch.equal(_at(st, path), _at(cache, path)), path


@pytest.mark.parametrize("name", ["xlstm", "zamba2_tail", "mamba2_lite"])
def test_generate_matches_reference(models, name):
    """Greedy tokens equal the reference engine's, which pairs its caches
    by key and, like the port, decodes from a zero recurrent state."""
    jcfg, tcfg, jp, tp = models(name)
    tok = _tokens(jcfg, 3, 12, 13)
    exp = JServeEngine(jcfg, jp, max_len=32).generate(
        {"tokens": jnp.asarray(tok)}, n_new=8)
    got = TServeEngine(tcfg, tp, max_len=32, device="cpu").generate(
        {"tokens": tok}, n_new=8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(exp))


def _reordered(tree):
    """The tree with every dict's keys inserted in reverse order."""
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in reversed(list(tree))}
    return tree


def test_generate_pairs_caches_by_key(models):
    """A prefill cache whose keys come in another order from init_cache's
    ({"mamba_tail", "shared", "mamba"} against {"mamba", "shared",
    "mamba_tail"}, each level reversed) is paired by key: the tokens equal
    the reference's. A prefill cache without one of the keys raises."""
    jcfg, tcfg, jp, tp = models("zamba2_tail")
    tok = _tokens(jcfg, 2, 10, 14)
    exp = JServeEngine(jcfg, jp, max_len=24).generate(
        {"tokens": jnp.asarray(tok)}, n_new=6)
    eng = TServeEngine(tcfg, tp, max_len=24, device="cpu")
    prefill = eng._prefill

    def reordered_prefill(params, batch):
        logits, cache = prefill(params, batch)
        return logits, _reordered(cache)
    eng._prefill = reordered_prefill
    assert list(reordered_prefill(tp, {"tokens": torch.from_numpy(tok)})[1]
                ) == ["mamba_tail", "shared", "mamba"]
    got = eng.generate({"tokens": tok}, n_new=6)
    np.testing.assert_array_equal(got, np.asarray(exp))

    def missing_prefill(params, batch):
        logits, cache = prefill(params, batch)
        del cache["mamba_tail"]
        return logits, cache
    eng._prefill = missing_prefill
    with pytest.raises(ValueError, match="does not pair"):
        eng.generate({"tokens": tok}, n_new=2)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def train_setups():
    """arch -> (reference local, lite, port local, lite, reference params):
    the fp32 smoke cut and its LiteModel, as launch/train.py --smoke cuts
    them (xlstm's LiteModel: 2 mLSTM blocks; zamba2's: 2 Mamba2 blocks)."""
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
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_train_step_matches_reference(train_setups, arch, mode):
    """loss_and_grads (plain and loss_chunk) and one AdamW step on 4 x 16
    tokens: every gradient, the metrics, the grad norm and the new params;
    the microbatched step's gradients are the mean of the reference's over
    the two halves of the batch."""
    jcfg, jlite, tcfg_, tlite, jparams = train_setups(arch)
    kw = {"plain": {}, "loss_chunk": {"loss_chunk": 8},
          "microbatch": {"microbatch": 2}}[mode]
    jt, tt = jstep.TrainStepConfig(**kw), tstep.TrainStepConfig(**kw)
    rng = np.random.default_rng(15)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grad = jax.jit(jax.grad(
        lambda p, b: jstep._losses(p, jcfg, jlite, jt, b)[0]))
    if mode == "microbatch":
        halves = [grad(jparams, {k: v[i * 2:(i + 1) * 2]
                                 for k, v in jb.items()}) for i in range(2)]
        jgrads = jax.tree_util.tree_map(lambda a, b: a / 2 + b / 2, *halves)
    else:
        jgrads = grad(jparams, jb)
    jgrads = jax.device_get(jgrads)
    jnew, jm = jax.jit(jstep.make_hapfl_train_step(jcfg, jlite, jt))(
        {"params": jparams, "opt": jopt.adamw(jt.lr).init(jparams)}, jb)
    jnew = jax.device_get(jnew["params"])

    params = params_from_numpy(jparams, device="cpu")
    if mode != "microbatch":
        _, grads = tstep.loss_and_grads(params, tcfg_, tlite, tt, tb)
        assert sorted(_paths(grads)) == sorted(_paths(jgrads))
        for path in _paths(grads):
            _close(_at(grads, path), _at(jgrads, path), TRAIN_TOL, str(path))
    state = {"params": params, "opt": topt.adamw(tt.lr).init(params)}
    state, tm = tstep.make_hapfl_train_step(tcfg_, tlite, tt)(state, tb)
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


@pytest.mark.parametrize("name", ["xlstm_tail", "zamba2_tail"])
def test_remat_gradients_are_the_plain_gradients(models, name):
    """With remat (each mLSTM or Mamba2 block under checkpoint, each zamba
    segment as a whole) the gradients are those without, bit for bit: the
    checkpointed forward runs again, the same ops on the same inputs."""
    _, tcfg, _, tp = models(name)
    lite = dataclasses.replace(tcfg.lite(), remat=False)
    gen = torch.Generator().manual_seed(16)
    params = {"local": tp, "lite": tapi.init_model(gen, lite, device="cpu")}
    tok = torch.from_numpy(_tokens(tcfg, 2, 16, 16)).long()
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        m, g = tstep.loss_and_grads(params, cfg, lite,
                                    tstep.TrainStepConfig(), batch)
        out.append((float(m["loss"]), tree_leaves(g)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
