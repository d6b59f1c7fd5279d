"""The port's cohort engine and HAPFL server against the reference's, on the
CPU at the small config of tests/test_batched.py.

Across frameworks the float32 GEMMs and convolutions sum in another order,
so trained params agree to atol 1e-4 / rtol 1e-3 rather than bitwise; the
host-side decisions (clients, sizes, intensities, simulated times) come from
the same numpy streams and must be identical."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fl as jfl
from repro_torch import fl as tfl
from repro_torch.convert import params_from_numpy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves

KW = dict(dataset="mnist", n_train=400, n_test=100, batches_per_epoch=1,
          default_epochs=2, n_clients=6, k_per_round=4,
          size_names=("small", "large"))
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run on one intra-op thread (the port's CPU tests import this): the
    suite runs several workers at once, and the HAPFL path's thousands of
    tiny ops slow down many times over when every worker's thread pool
    spins on every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_close(got, exp, atol=ATOL, rtol=RTOL):
    """got: a tree of tensors; exp: the reference's tree, compared by path
    (JAX flattens dicts in sorted key order, the port in insertion order)."""
    if isinstance(exp, dict):
        assert set(got) == set(exp)
        for k in exp:
            _assert_trees_close(got[k], exp[k], atol, rtol)
    elif isinstance(exp, (list, tuple)):
        for g, e in zip(got, exp):
            _assert_trees_close(g, e, atol, rtol)
    else:
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   np.asarray(exp), atol=atol, rtol=rtol)


def _port_server(jsrv, **kw):
    """A CPU port server holding the reference server's globals and PPO
    params (jax.random streams cannot be reproduced in PyTorch)."""
    srv = tfl.HAPFLServer(tfl.FLEnvironment(tfl.FLSimConfig(**KW)),
                          device="cpu", **kw)
    conv = lambda t: params_from_numpy(jax.device_get(t), "cpu")
    srv.lite_params = conv(jsrv.lite_params)
    srv.global_by_size = {s: conv(p) for s, p in jsrv.global_by_size.items()}
    for mine, ref in ((srv.allocator.agent, jsrv.allocator.agent),
                      (srv.intensity.agent, jsrv.intensity.agent)):
        mine.params = conv(ref.params)
        mine.opt_state = mine.opt.init(mine.params)
    return srv


COHORT = ([0, 1, 2, 3], ["small", "small", "large", "large"], [1, 3, 2, 1])


def test_cohort_matches_reference_batched_engine():
    """The 2-size ragged 4-client cohort of tests/test_batched.py: every
    trained leaf of both models against the reference's batched engine."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=5,
                           engine="batched")
    exp = jsrv.batched_engine.train_cohort(*COHORT, jsrv.global_by_size,
                                           jsrv.lite_params)
    srv = _port_server(jsrv, engine="batched")
    got = srv.batched_engine.train_cohort(*COHORT, srv.global_by_size,
                                          srv.lite_params)
    for g, e in zip(got, exp):
        _assert_trees_close(g, e)


def test_pad_invariance_is_exact():
    """Pow2 step padding and dummy clients never touch a real client's
    params or optimizer state: padded and exact runs agree bitwise. The
    sequential engine (one client per step) runs GEMMs of another batch
    count, which may block their sums differently, so it agrees to float
    tolerance."""
    srv = tfl.HAPFLServer(tfl.FLEnvironment(tfl.FLSimConfig(**KW)), seed=0,
                          device="cpu", engine="sequential")
    runs = []
    for pad in (True, False):
        eng = tfl.BatchedClientEngine(tfl.FLEnvironment(tfl.FLSimConfig(**KW)),
                                      device="cpu")
        runs.append(eng.train_cohort([1, 4], ["small", "small"], [1, 3],
                                     srv.global_by_size, srv.lite_params,
                                     pad_pow2=pad, pad_clients=pad))
    seq = [srv._client_train(c, "small", t) for c, t in ((1, 1), (4, 3))]
    for padded, exact, one in zip(*runs, seq):
        for a, b, c in zip(tree_leaves(padded), tree_leaves(exact),
                           tree_leaves(one)):
            assert torch.equal(a, b)
            torch.testing.assert_close(c, b, atol=1e-5, rtol=1e-4)


def test_pretrain_rl_matches_reference():
    """Latency-only rounds fill both PPO buffers (B=5) and run one update
    each: identical decisions before it, and the update's metrics track the
    reference's. With deterministic actions PPO2 acts at its Gaussian mean,
    where the log-prob's gradient in the mean is exactly zero; Adam then
    scales float noise up to lr-sized steps in either framework, so only
    PPO2's critic-side metrics are compared."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=1)
    srv = _port_server(jsrv)
    # "auto" keeps the reference's CPU rule: sequential at batch 32
    assert srv.engine == jsrv.engine == "sequential"
    for _ in range(5):
        j = jsrv.run_round(latency_only=True, deterministic=True)
        t = srv.run_round(latency_only=True, deterministic=True)
        assert (t.sizes, t.intensities) == (j.sizes, j.intensities)
        assert (t.straggling, t.reward_ppo1, t.reward_ppo2) == (
            j.straggling, j.reward_ppo1, j.reward_ppo2)
    for agent, keys in (("allocator", None),
                        ("intensity", ("critic_loss", "value_loss",
                                       "mean_return", "adv_mean",
                                       "adv_std"))):
        ja = getattr(jsrv, agent).agent
        ta = getattr(srv, agent).agent
        assert ta.n_updates == ja.n_updates == 1
        assert set(ta.last_update) == set(ja.last_update)
        for k in keys or ja.last_update:
            assert ta.last_update[k] == pytest.approx(
                ja.last_update[k], abs=1e-5, rel=1e-5), (agent, k)


def test_unported_options_raise():
    """Only the mesh-sharded engine is still unported; cross-size
    aggregation and codecs construct (tests/test_torch_nested.py and
    tests/test_torch_comm.py hold them against the reference)."""
    env = tfl.FLEnvironment(tfl.FLSimConfig(**KW))
    for kw in ({"engine": "sharded"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfl.HAPFLServer(env, device="cpu", **kw)
    srv = tfl.HAPFLServer(env, device="cpu", aggregation="cross_size",
                          codec="int8")
    assert (srv.aggregation, srv.codec.name) == ("cross_size", "int8")
    with pytest.raises(ValueError):
        tfl.HAPFLServer(env, device="cpu", engine="warp-drive")
    assert resolve_device("cpu") == torch.device("cpu")
