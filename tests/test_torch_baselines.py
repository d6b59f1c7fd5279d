"""The port's baselines (FedAvg, FedProx, pFedMe, FedDdrl; paper §V.B) and
their plain-CE step against the reference's, on the CPU.

The port trains a round's clients as one stacked cohort where the reference
scans one client at a time; both draw each client's batches from its own
loader in the same order, so the host data and every host-side record
field are identical, and the globals agree to the engines' atol 1e-4 / rtol
1e-3 (float32 sums in another order across frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fl as jfl
from repro.core.distill import _ce as jce, \
    make_single_train_fns as jmake_single_train_fns
from repro.models.cnn import apply_cnn as japply_cnn, cnn_pool as jcnn_pool, \
    init_cnn as jinit_cnn
from repro_torch import fl as tfl
from repro_torch.convert import params_from_numpy
from repro_torch.core.distill import make_single_train_fns
from repro_torch.models.cnn import apply_cnn, apply_cnn_fast, cnn_pool
from repro_torch.utils.pytree import tree_map
from test_torch_server import KW, _assert_trees_close
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

ALGOS = ["fedavg", "fedprox", "pfedme", "fedddrl"]


def _deterministic(allocator):
    """PPO2 acting at its Gaussian mean (torch cannot draw jax.random's
    samples); set on both runners, in the test only."""
    assign = allocator.assign
    allocator.assign = lambda key, times, deterministic=False: assign(
        key, times, True)


@pytest.mark.parametrize("algo", ALGOS)
def test_baseline_round_matches_reference(algo):
    """One round from the reference's globals (and, for FedDdrl, its PPO2
    params): identical host record fields, close globals."""
    jr = jfl.BaselineRunner(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), algo,
                            seed=0)
    tr = tfl.BaselineRunner(tfl.FLEnvironment(tfl.FLSimConfig(**KW)), algo,
                            device="cpu")
    conv = lambda t: params_from_numpy(jax.device_get(t), "cpu")
    tr.global_params = conv(jr.global_params)
    if algo == "pfedme":
        tr.personal = {i: tr.global_params for i in tr.personal}
    if algo == "fedddrl":
        agent = tr.intensity.agent
        agent.params = conv(jr.intensity.agent.params)
        agent.opt_state = agent.opt.init(agent.params)
        _deterministic(jr.intensity)
        _deterministic(tr.intensity)
    je, te = jr.run_round(), tr.run_round()
    assert (te.round_idx, te.straggling, te.wall_time, te.latency_only) == (
        je.round_idx, je.straggling, je.wall_time, je.latency_only)
    assert list(te.client_acc) == list(je.client_acc)
    # params agree to ~1e-5, so an argmax may flip on one test sample
    for c in je.client_acc:
        n = min(len(tr.env.partitions[c]), 256)
        assert abs(te.client_acc[c] - je.client_acc[c]) <= 1.5 / n
    assert abs(te.acc_global - je.acc_global) <= 1.5 / KW["n_test"]
    _assert_trees_close(tr.global_params, jax.device_get(jr.global_params))
    if algo == "pfedme":
        for c in je.client_acc:
            _assert_trees_close(tr.personal[c],
                                jax.device_get(jr.personal[c]))
    assert set(tr.summary()) == set(jr.summary())


@pytest.mark.parametrize("stacked", [False, True])
def test_single_train_step_with_prox_matches_reference(stacked):
    """make_single_train_fns with prox_mu > 0: the loss and the gradient
    (the momentum buffer after one step) against jax.value_and_grad of the
    reference's CE + 0.5 * mu * sum ||p - g||^2, and the stepped params
    against the reference's step, at 1e-5. Stacked, two clients go through
    apply_cnn_fast at once and each gets its own gradient."""
    cfg, mu, lr = jcnn_pool("mnist")["small"], 0.3, 0.05
    rng = np.random.default_rng(0)
    g = jax.device_get(jinit_cnn(jax.random.PRNGKey(1), cfg))
    ps = [jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), g) for _ in range(2)]
    xs = rng.random((2, 8) + cfg.in_shape).astype(np.float32)
    ys = rng.integers(0, cfg.n_classes, (2, 8)).astype(np.int32)

    def jloss(p, x, y):
        sq = jax.tree_util.tree_map(lambda a, b: jnp.sum(jnp.square(a - b)),
                                    p, g)
        return (jce(japply_cnn(p, cfg, x), y)
                + 0.5 * mu * sum(jax.tree_util.tree_leaves(sq)))

    jstep, jinit = jmake_single_train_fns(
        lambda p, x: japply_cnn(p, cfg, x), lr=lr, prox_mu=mu)
    tcfg = cnn_pool("mnist")["small"]
    apply = ((lambda p, x: apply_cnn_fast(p, tcfg, x)) if stacked
             else (lambda p, x: apply_cnn(p, tcfg, x)))
    step, init = make_single_train_fns(apply, lr=lr, prox_mu=mu)
    tg = params_from_numpy(g, "cpu")
    tps = [params_from_numpy(p, "cpu") for p in ps]
    if stacked:
        params = tree_map(lambda *ls: torch.stack(ls), *tps)
        new, state, m = step(params, init(params), torch.from_numpy(xs),
                             torch.from_numpy(ys), tg)
        outs = [(tree_map(lambda a, i=i: a[i], new),
                 tree_map(lambda a, i=i: a[i], state["mu"])) for i in range(2)]
        loss = float(m["loss"])
    else:
        new, state, m = step(tps[0], init(tps[0]), torch.from_numpy(xs[0]),
                             torch.from_numpy(ys[0]), tg)
        outs, loss = [(new, state["mu"])], float(m["loss"])
    jl_total = 0.0
    for i, (tnew, tgrad) in enumerate(outs):
        jl, jgrad = jax.value_and_grad(jloss)(ps[i], xs[i], ys[i])
        jl_total += float(jl)
        _assert_trees_close(tgrad, jax.device_get(jgrad), 1e-5, 1e-5)
        jnew, _, _ = jstep(ps[i], jinit(ps[i]), xs[i], ys[i], g)
        _assert_trees_close(tnew, jax.device_get(jnew), 1e-5, 1e-5)
    assert loss == pytest.approx(jl_total, abs=1e-5, rel=1e-5)


@pytest.mark.slow
def test_rl_warmup_reduces_straggling():
    """The dual-agent RL must cut straggling latency vs its own untrained
    start (paper's central claim, scaled down), on the port."""
    cfg = tfl.FLSimConfig(dataset="mnist", n_train=600, n_test=150,
                          batches_per_epoch=1, default_epochs=4)
    srv = tfl.HAPFLServer(tfl.FLEnvironment(cfg), seed=1, device="cpu")
    hist = srv.pretrain_rl(1500)
    early = np.mean([h["straggling"] for h in hist[:150]])
    late = np.mean([h["straggling"] for h in hist[-150:]])
    assert late < 0.8 * early, (early, late)
