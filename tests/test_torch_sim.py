"""The port's event-driven simulator (repro_torch.sim), fleet health and PPO
diagnostics (repro_torch.obs.health, repro_torch.obs.rl) on the CPU.

Within the port, the sync policy must reproduce `HAPFLServer.run` bit for
bit, and observation (a health tracker, the tracer) must not perturb a run.
Against the reference, the scheduler's host-side records (clients, sizes,
intensities, virtual times, staleness, wire bytes) come from the same numpy
streams and must be identical with PPO off; the per-wave policy entropies
of a traced run hold at 1e-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import fl as jfl, sim as jsim
from repro.core.latency import make_comm_model as jmake_comm_model
from repro.obs import rl as jrl, trace as jtrace
from repro_torch import fl as tfl, sim as tsim
from repro_torch.core.latency import make_comm_model
from repro_torch.obs import trace as ttrace
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import KW, _port_server
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dataset="mnist", n_train=300, n_test=80, n_clients=8,
           k_per_round=4, batches_per_epoch=1, default_epochs=2,
           batch_size=16)


@pytest.fixture(autouse=True)
def _tracers_off():
    """Every test starts and ends with both packages' tracing disabled."""
    ttrace.disable()
    jtrace.disable()
    yield
    ttrace.disable()
    jtrace.disable()


def _server(seed=3, **kw):
    return tfl.HAPFLServer(tfl.FLEnvironment(tfl.FLSimConfig(**CFG)),
                           seed=seed, device="cpu", **kw)


def _record_fields(rec):
    d = dataclasses.asdict(rec)
    d.pop("rl_diag")
    return d


def test_sync_policy_reproduces_server_run_exactly():
    """tests/test_sim.py's property on the port: the sync policy's event
    path is the barrier round, record for record and bit for bit."""
    srv_a = _server()
    recs_a = srv_a.run(3)
    srv_b = _server()
    res = tsim.EventScheduler(srv_b, tsim.SyncPolicy()).run(waves=3)
    assert len(srv_b.history) == 3
    for a, b in zip(recs_a, srv_b.history):
        assert _record_fields(a) == _record_fields(b)
    for x, y in zip(tree_leaves([srv_a.lite_params, srv_a.global_by_size]),
                    tree_leaves([srv_b.lite_params, srv_b.global_by_size])):
        assert torch.equal(x, y)
    assert res.sim_time == pytest.approx(sum(r.wall_time for r in recs_a))


def _comm(pool, lite, n, make):
    return make({s: float(c.num_params()) for s, c in pool.items()},
                float(lite.num_params()), n, mean_mbps=0.5, codec="int8",
                model_tensors={s: c.num_tensors() for s, c in pool.items()},
                lite_tensors=lite.num_tensors())


@pytest.mark.parametrize("policy", ["buffered", "async"])
def test_scheduler_host_records_match_reference(policy):
    """PPO off, codec-priced links: the same waves, the same virtual times,
    the same aggregation records and byte counts as the reference's
    scheduler (params differ only at float tolerance, which no host field
    reads with accuracy evaluation off)."""
    kw = dict(buffer_m=2) if policy == "buffered" else {}
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=2,
                           use_ppo1=False, use_ppo2=False, engine="batched")
    srv = _port_server(jsrv, use_ppo1=False, use_ppo2=False,
                       engine="batched")
    results = []
    for mod, s, make in ((jsim, jsrv, jmake_comm_model),
                         (tsim, srv, make_comm_model)):
        comm = _comm(s.env.pool, s.env.lite_cfg, KW["n_clients"], make)
        sched = mod.EventScheduler(s, mod.make_policy(policy, **kw),
                                   comm=comm, eval_accuracy=False)
        results.append(sched.run(waves=4))
    jres, tres = results
    assert tres.summary() == jres.summary()
    assert [(r.time, r.version, r.n_updates, r.staleness, r.straggling)
            for r in tres.records] == [
        (r.time, r.version, r.n_updates, r.staleness, r.straggling)
        for r in jres.records]
    assert len(srv.history) == len(jsrv.history) == 4
    for a, b in zip(srv.history, jsrv.history):
        assert (a.clients, a.sizes, a.intensities, a.assess_times,
                a.local_times, a.straggling, a.wall_time) == (
            b.clients, b.sizes, b.intensities, b.assess_times,
            b.local_times, b.straggling, b.wall_time)


def test_health_off_runs_are_byte_identical():
    """Attaching a FleetHealth must not perturb the simulation: every output
    except the observational side channels (rl_diag, health) is identical
    to a plain run."""
    srv_a = _server()
    res_a = tsim.EventScheduler(srv_a, tsim.SyncPolicy()).run(waves=2)
    srv_b = _server()
    res_b = tsim.EventScheduler(srv_b, tsim.SyncPolicy(),
                                health=True).run(waves=2)
    for a, b in zip(srv_a.history, srv_b.history):
        assert a.rl_diag is None and b.rl_diag is not None
        assert _record_fields(a) == _record_fields(b)
    da, db = dataclasses.asdict(res_a), dataclasses.asdict(res_b)
    assert da.pop("health") is None and db.pop("health") is not None
    assert da == db
    for x, y in zip(tree_leaves(srv_a.global_by_size),
                    tree_leaves(srv_b.global_by_size)):
        assert torch.equal(x, y)


def test_traced_rounds_carry_rl_diag_matching_reference():
    """Four traced latency-only waves (before the first PPO update, B = 5)
    from the reference's PPO params, deterministic: each record's rl_diag
    has both agents, entropies within 1e-5 of repro.obs.rl's, the same
    rewards and buffer fill; the counters land in the trace; and an
    untraced run of the same waves is the same run with rl_diag None."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=1)
    srv = _port_server(jsrv)
    plain = _port_server(jsrv)
    tracer = ttrace.Tracer()
    ttrace.enable(tracer)
    jtrace.enable(jtrace.Tracer())
    try:
        for _ in range(4):
            jr = jsrv.run_round(latency_only=True, deterministic=True)
            tr = srv.run_round(latency_only=True, deterministic=True)
            assert set(tr.rl_diag) == set(jr.rl_diag) == {"ppo1", "ppo2"}
            for agent in ("ppo1", "ppo2"):
                t, j = tr.rl_diag[agent], jr.rl_diag[agent]
                assert set(t) == set(j)
                assert t["entropy"] == pytest.approx(j["entropy"], abs=1e-5)
                for k in ("reward", "buffer_fill", "n_updates"):
                    assert t[k] == pytest.approx(j[k], abs=1e-9), k
                assert t["approx_kl"] is None and j["approx_kl"] is None
            # the port's entropy against the reference's function on the
            # state the port's agent acted on
            st = srv.allocator._pending["state"]
            assert tr.rl_diag["ppo1"]["entropy"] == pytest.approx(
                jrl.policy_entropy(jsrv.allocator.agent, st), abs=1e-5)
    finally:
        ttrace.disable()
        jtrace.disable()
    names = {e["name"] for e in tracer.events if e["ph"] == "C"}
    assert {"rl.ppo1", "rl.ppo2", "rl.reward"} <= names
    recs = [plain.run_round(latency_only=True, deterministic=True)
            for _ in range(4)]
    for a, b in zip(recs, srv.history):
        assert a.rl_diag is None
        assert _record_fields(a) == _record_fields(b)
