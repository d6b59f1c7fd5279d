"""The port's optimizers and PPO core against the reference's: several sgd
and adamw steps on fixed grads, deterministic actions on converted params,
and one PPO update on an identical buffer."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ppo as jppo
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ppo as tppo
from repro_torch.optim import optimizers as topt
from repro_torch.utils.pytree import tree_add, tree_leaves

# float32 on both sides; XLA and PyTorch order some sums differently
TOL = 1e-5


def _assert_trees_close(got, exp, tol=TOL):
    """got: a tree of tensors; exp: the same tree of JAX arrays. Compared by
    path, so dict key order does not matter."""
    exp = jax.device_get(exp)
    if isinstance(exp, dict):
        assert set(got) == set(exp)
        for k in exp:
            _assert_trees_close(got[k], exp[k], tol)
    elif isinstance(exp, (list, tuple)):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            _assert_trees_close(g, e, tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                                   atol=tol, rtol=tol)


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": f(3, 4), "b": [f(5), f(2, 2)]}


@pytest.mark.parametrize("name,kw", [("sgd", {}),
                                     ("sgd", {"momentum": 0.9}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.01})])
def test_optimizer_steps_match_reference(name, kw):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(4)]
    jo, to = getattr(jopt, name)(1e-2, **kw), getattr(topt, name)(1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, ju)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        tp = tree_add(tp, tu)
    _assert_trees_close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == len(grads)
    moments = ("mu",) if name == "sgd" else ("m", "v")
    for k in moments:
        if js[k] is None:
            assert ts[k] is None
        else:
            _assert_trees_close(ts[k], js[k])


def _agents(kind, seed=0):
    """A reference PPOAgent and a port PPOAgent holding the same params."""
    kw = dict(state_dim=4, kind=kind, n_categories=3)
    ja = jppo.PPOAgent(jppo.PPOConfig(**kw), jax.random.PRNGKey(seed))
    ta = tppo.PPOAgent(tppo.PPOConfig(**kw),
                       torch.Generator().manual_seed(seed), "cpu")
    ta.params = params_from_numpy(jax.device_get(ja.params), "cpu")
    ta.opt_state = ta.opt.init(ta.params)
    return ja, ta


@pytest.mark.parametrize("kind", ["categorical_multihead", "gaussian_simplex"])
def test_deterministic_act_matches_reference(kind):
    ja, ta = _agents(kind)
    rng = np.random.default_rng(1)
    for _ in range(3):
        s = rng.uniform(0.0, 2.0, 4).astype(np.float32)
        ja_a, ja_lp = ja.act(jax.random.PRNGKey(0), s, deterministic=True)
        ta_a, ta_lp = ta.act(torch.Generator(), s, deterministic=True)
        if kind == "categorical_multihead":
            np.testing.assert_array_equal(ta_a, ja_a)
        else:
            np.testing.assert_allclose(ta_a, ja_a, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ta_lp, ja_lp, atol=TOL, rtol=TOL)


def test_discounted_returns_matches_reference():
    r = np.random.default_rng(2).standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        tppo.discounted_returns(torch.from_numpy(r), 0.3).numpy(),
        np.asarray(jppo.discounted_returns(jnp.asarray(r), 0.3)),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["categorical_multihead", "gaussian_simplex"])
def test_ppo_update_matches_reference(kind):
    """One clipped-PPO update on an identical 5-entry buffer (sampled by the
    reference's policy): params, optimizer moments and every metric."""
    ja, ta = _agents(kind, seed=3)
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(5)
    for _ in range(5):
        s = rng.uniform(0.0, 2.0, 4).astype(np.float32)
        key, sub = jax.random.split(key)
        a, lp = ja.act(sub, s)
        r = float(rng.standard_normal())
        ja.store(s, a, lp, r)
        ta.store(s, a, lp, r)
    batch = {k: np.stack([b[k] for b in ja.buffer]) for k in ja.buffer[0]}
    jp, js, jm = jax.jit(functools.partial(jppo._ppo_update, cfg=ja.cfg))(
        ja.params, ja.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts, tm = tppo._ppo_update(
        ta.params, ta.opt_state,
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg=ta.cfg)
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts["m"], js["m"])
    _assert_trees_close(ts["v"], js["v"])
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)
    # the agent wrapper runs the same update once its buffer is full
    out = ta.maybe_update()
    assert ta.buffer == [] and ta.n_updates == 1
    assert out == pytest.approx({k: float(v) for k, v in tm.items()})
    for a, b in zip(tree_leaves(params_to_numpy(ta.params)),
                    tree_leaves(params_to_numpy(tp))):
        np.testing.assert_array_equal(a, b)
