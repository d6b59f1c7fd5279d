"""The port's MoE family against the reference on the CPU: `models/moe.py`
(init, capacity, routing, dispatch, the aux losses and the vjp), the MoE
decoders' forward, prefill / decode, the sliding-window ring buffer and
ServeEngine.generate. Params are made by the reference and carried over
through numpy (repro_torch.convert). The configs are the smoke cuts of
qwen3-moe-30b-a3b and mixtral-8x7b (4 experts, top-2, d 256).

Routing is held exactly: the expert indices and the dropped (token, slot)
pairs are bitwise the reference's. Each routing test first asserts its own
precondition, that the k-th and (k+1)-th router probabilities of every
token are more than 1e-5 apart, so that a float near-tie cannot flip a
route. Tolerances: y at 1e-5 (fp32) and 2e-2 (bf16: XLA and PyTorch may
sum the combine over k in other widths), the aux losses at 1e-5, model
logits at 1e-4, prefill / decode against the full forward at 2e-4 (as
tests/test_decode.py); generated tokens are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import make_decode_step
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
GAP = 1e-5

_jforward = jax.jit(japi.forward, static_argnums=1)
_jprefill = jax.jit(japi.prefill, static_argnums=1)
_jdecode = jax.jit(japi.decode_step, static_argnums=1)


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jget_config(arch).smoke(), **overrides),
            dataclasses.replace(tget_config(arch).smoke(), **{
                k: (getattr(torch, jnp.dtype(v).name) if k == "dtype" else v)
                for k, v in overrides.items()}))


def _close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _moe_inputs(jcfg, seed, N=48):
    """The reference's MoE params for jcfg, x (1, N, d) in jcfg.dtype, and
    the port's copies of both (bit for bit)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (1, N, jcfg.d_model)).astype(np.float32)).astype(jcfg.dtype)
    tp, tx = params_from_numpy(jax.device_get((jp, x)), device="cpu")
    return jp, x, tp, tx


def _reference_routes(jp, jcfg, x):
    """The reference's routing of x, in its own jnp ops
    (src/repro/models/moe.py:67-89 with one group): probs (N, E), top_i
    (N, k) and keep (N k,)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, jcfg.top_k)
    C = jmoe.expert_capacity(xt.shape[0], jcfg.top_k, jcfg.n_experts,
                             jcfg.capacity_factor)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return np.asarray(probs), np.asarray(top_i), np.asarray(pos < C)


def _assert_no_near_tie(probs, k):
    """The test's precondition: the smallest gap between a token's k-th and
    (k+1)-th router probability is above GAP."""
    srt = -np.sort(-probs, axis=-1)
    gap = float((srt[:, k - 1] - srt[:, k]).min())
    assert gap > GAP, f"a near-tie in the routing: gap {gap}"


# ---------------------------------------------------------------------- #
# models/moe.py
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_reference(arch):
    """init_moe's leaves, and init_model's whole tree, shape and dtype leaf
    for leaf the reference's: bf16 expert stacks, an fp32 router."""
    jcfg, tcfg = _cfgs(arch, dtype=jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    own = tmoe.init_moe(gen, tcfg, "cpu")
    ref = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    assert set(own) == set(ref) == {"router", "w_up", "w_gate", "w_down"}
    for key, leaf in ref.items():
        assert tuple(own[key].shape) == leaf.shape
        assert str(own[key].dtype).removeprefix("torch.") == leaf.dtype.name
    assert own["router"].dtype == torch.float32
    assert own["w_up"].dtype == torch.bfloat16
    model = tapi.init_model(gen, tcfg, device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(
        japi.init_model(jax.random.PRNGKey(0), jcfg))[0]
    assert len(tree_leaves(model)) == len(ref)
    for path, leaf in ref:
        node = model
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name


def test_expert_capacity_matches_reference():
    cases = [(n, k, E, cf) for n in (1, 4, 48, 2048) for k in (1, 2, 8)
             for E in (4, 8, 128) for cf in (1.0, 1.25, 8.0)]
    for case in cases:
        assert tmoe.expert_capacity(*case) == jmoe.expert_capacity(*case)
    # the path's shapes: qwen3-moe prefill / train, decode, mixtral
    assert tmoe.expert_capacity(2048, 8, 128, 1.25) == 160
    assert tmoe.expert_capacity(4, 8, 128, 1.25) == 8
    assert tmoe.expert_capacity(2048, 2, 8, 1.25) == 640


@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype, cf):
    """Expert indices and the dropped pairs bitwise, y at 1e-5 / 2e-2 and
    the aux losses at 1e-5; at capacity_factor 1.0 some pairs drop, at 8.0
    none."""
    jcfg, tcfg = _cfgs(arch, dtype=getattr(jnp, dtype), capacity_factor=cf)
    jp, x, tp, tx = _moe_inputs(jcfg, seed=ARCHS.index(arch))
    probs, top_i, keep = _reference_routes(jp, jcfg, x)
    _assert_no_near_tie(probs, jcfg.top_k)
    assert (not keep.all()) if cf == 1.0 else keep.all()

    ey, eaux = jmoe.apply_moe(jp, jcfg, x)
    with torch.no_grad():
        y, aux = tmoe.apply_moe(tp, tcfg, tx)
        _, _, _, own_i = tmoe.route(tp["router"], tcfg, tx[0])
        C = tmoe.expert_capacity(tx.shape[1], tcfg.top_k, tcfg.n_experts, cf)
        _, own_keep = tmoe.dispatch_slots(own_i, tcfg.n_experts, C)
    np.testing.assert_array_equal(own_i.numpy(), top_i)
    np.testing.assert_array_equal(own_keep.numpy(), keep)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y.float(), np.asarray(ey, np.float32),
           1e-5 if dtype == "float32" else 2e-2)
    assert set(aux) == set(eaux)
    for key in eaux:
        _close(aux[key], eaux[key], 1e-5)


def test_apply_moe_vjp_matches_reference():
    """The gradients of y and the two router losses with respect to x, the
    router and the three expert stacks, against jax.vjp (fp32, with drops:
    capacity_factor 1.0), at atol 1e-5, rtol 1e-4."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=1.0)
    jp, x, tp, tx = _moe_inputs(jcfg, seed=5)
    probs, _, keep = _reference_routes(jp, jcfg, x)
    _assert_no_near_tie(probs, jcfg.top_k)
    assert not keep.all()
    rng = np.random.default_rng(6)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    g_lb, g_z = 0.7, -0.3

    def jfun(p, xx):
        y, aux = jmoe.apply_moe(p, jcfg, xx)
        return y, aux["lb_loss"], aux["z_loss"]
    _, vjp = jax.vjp(jfun, jp, x)
    ejp, ex = vjp((jnp.asarray(gy), jnp.float32(g_lb), jnp.float32(g_z)))

    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xx = tx.clone().requires_grad_(True)
    y, aux = tmoe.apply_moe(leaves, tcfg, xx)
    names = sorted(leaves)
    grads = torch.autograd.grad(
        [y, aux["lb_loss"], aux["z_loss"]], [xx] + [leaves[k] for k in names],
        grad_outputs=[torch.from_numpy(gy), torch.tensor(g_lb),
                      torch.tensor(g_z)])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ex), atol=1e-5,
                               rtol=1e-4)
    for name, g in zip(names, grads[1:]):
        exp = np.asarray(ejp[name])
        assert np.abs(exp).max() > 0
        np.testing.assert_allclose(g.numpy(), exp, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------- #
# the MoE decoders
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, reference params, port params)."""
    made = {}

    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in made:
            jcfg, tcfg = _cfgs(arch, **overrides)
            jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
            made[key] = (jcfg, tcfg, jp,
                         params_from_numpy(jax.device_get(jp), device="cpu"))
        return made[key]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Logits at 1e-4 and every aux loss (summed over the layers, as the
    reference sums them) at 1e-5; mixtral at S 80, past its 64-token
    window."""
    jcfg, tcfg, jp, tp = models(arch)
    tok = _tokens(2, 80, jcfg.vocab_size, 1)
    exp, eaux = _jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32
    _close(got, exp, 1e-4)
    assert set(aux) == set(eaux) == {"lb_loss", "z_loss", "dropped_frac"}
    for key in eaux:
        _close(aux[key], eaux[key], 1e-5)


def _cut(d, sl):
    return {k: v[:, sl] for k, v in d.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(models, arch):
    """tests/test_decode.py's check on the port at capacity_factor 8.0 (no
    drops): prefill of S - 1 tokens and one decode step give the full
    forward's logits at 2e-4, and the decode step's logits are the
    reference's at 1e-4."""
    jcfg, tcfg, jp, tp = models(arch, capacity_factor=8.0)
    B, S = 2, 32
    tok = _tokens(B, S, jcfg.vocab_size, 2)
    batch = {"tokens": torch.from_numpy(tok)}
    with torch.no_grad():
        full, _ = tapi.forward(tp, tcfg, batch)
        last, pre = tapi.prefill(tp, tcfg, _cut(batch, slice(0, S - 1)))
        assert float((last[:, 0] - full[:, S - 2]).abs().max()) < 2e-4
        cache = tapi.make_decode_cache(tcfg, B, S, device="cpu")
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :S - 1] = pre["blocks"][key]
        logits, _ = tapi.decode_step(tp, tcfg, _cut(batch, slice(S - 1, S)),
                                     cache, S - 1)
    assert float((logits[:, 0] - full[:, S - 1]).abs().max()) < 2e-4
    _, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :S - 1])})
    jcache = jax.tree_util.tree_map(
        lambda big, small: jax.lax.dynamic_update_slice(big, small, (0,) * 5),
        japi.make_decode_cache(jcfg, B, S), jc)
    jl, _ = _jdecode(jp, jcfg, {"tokens": jnp.asarray(tok[:, S - 1:])},
                     jcache, S - 1)
    _close(logits, jl, 1e-4)


def test_sliding_window_ring_buffer(models):
    """tests/test_decode.py's ring-buffer check on the port: mixtral with an
    8-slot window, decoded one token at a time from an empty cache over 24
    positions, ends at the full windowed forward's logits (2e-4)."""
    jcfg, tcfg, jp, tp = models("mixtral-8x7b", sliding_window=8,
                                capacity_factor=8.0)
    T = 24
    tok = torch.from_numpy(_tokens(1, T, jcfg.vocab_size, 3))
    with torch.no_grad():
        full, _ = tapi.forward(tp, tcfg, {"tokens": tok})
        cache = tapi.make_decode_cache(tcfg, 1, T, device="cpu")
        assert cache["blocks"]["k"].shape[2] == 8
        for t in range(T):
            logits, cache = tapi.decode_step(tp, tcfg,
                                             {"tokens": tok[:, t:t + 1]},
                                             cache, t)
    err = float((logits[:, 0] - full[:, T - 1]).abs().max())
    assert err < 2e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(models, arch):
    """Greedy tokens identical at the configs' own capacity factor (1.25:
    the prefill's 2 x 6 tokens and each decode step's 2 route with drops
    the reference's way); mixtral with an 8-slot window that 16 steps
    wrap twice."""
    over = {"sliding_window": 8} if arch == "mixtral-8x7b" else {}
    jcfg, tcfg, jp, tp = models(arch, **over)
    tok = _tokens(2, 6, jcfg.vocab_size, 4)
    exp = JServeEngine(jcfg, jp, max_len=32).generate(
        {"tokens": jnp.asarray(tok)}, n_new=16)
    got = TServeEngine(tcfg, tp, max_len=32, device="cpu").generate(
        {"tokens": tok}, n_new=16)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_generate_logits_are_the_decode_step_loop(models):
    """The engine's static decode step with MoE blocks (the code a CUDA graph
    captures on the card) equals a plain loop of make_decode_step bit for
    bit on the CPU."""
    jcfg, tcfg, jp, tp = models("qwen3-moe-30b-a3b")
    tok = _tokens(2, 6, jcfg.vocab_size, 5)
    eng = TServeEngine(tcfg, tp, max_len=24, device="cpu")
    got, logits = eng.generate({"tokens": tok}, n_new=8, return_logits=True)
    step = make_decode_step(tcfg)
    with torch.no_grad():
        first, pre = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)})
        cache = tapi.make_decode_cache(tcfg, 2, 24, device="cpu")
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :6] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        for i in range(8):
            nxt, lg, cache = step(tp, {"tokens": nxt[:, None]}, cache,
                                  torch.tensor(6 + i))
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.numpy(), got[:, i])
