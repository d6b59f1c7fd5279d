"""The port's parameter service (repro_torch.service) on the CPU.

Within the port: tests/test_service.py's streaming ingest, admission and
churn, codec wire accounting, observability, and the bit-identical
kill/restore pin (identity and topk+int8), with the server's
torch.Generator state in place of the reference's PRNG key.

Against the reference `ParamService`, from the same starting globals (the
reference's, through convert.py) with PPO off (torch cannot draw
jax.random's actions): the same Poisson trace gives the same event log,
records, deterministic counters, staleness histogram and byte counts, and
globals within 1e-5 (the two frameworks sum the aggregation in another
order); `synth_update` of equal references is bitwise the reference's."""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fl as jfl, service as jservice
from repro.core.latency import AvailabilityModel as JAvailabilityModel
from repro_torch.comm import make_codec
from repro_torch.convert import params_from_numpy
from repro_torch.core.latency import AvailabilityModel
from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
from repro_torch.service import (LoadGenerator, ParamService,
                                 latest_checkpoint, poisson_trace,
                                 synth_update)
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dataset="mnist", n_train=200, n_test=60, n_clients=6,
           k_per_round=3, batches_per_epoch=1, default_epochs=2,
           batch_size=16)
GLOBALS_ATOL = 1e-5


def _server(seed=0, codec=None, **kw):
    env = FLEnvironment(FLSimConfig(seed=seed, **CFG))
    return HAPFLServer(env, seed=seed, codec=codec, device="cpu", **kw)


def _build(codec=None, policy="async", availability=None, seed=0, **kw):
    kw.setdefault("min_deadline", 50.0)
    return ParamService(_server(seed, codec), policy=policy,
                        availability=availability, **kw)


def _teq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(la, lb))


def _by_path_equal(a, b):
    """Trees equal leaf by leaf by key (dict orders may differ: codec
    decodes and synth_update give jax.tree_util's sorted order)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_by_path_equal(a[k], b[k])
                                        for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_by_path_equal(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------------------------- #
# dispatch / admission
# ---------------------------------------------------------------------- #
def test_dispatch_issues_ppo_assigned_tickets():
    svc = _build()
    tickets = svc.dispatch([0, 1], now=0.0)
    assert [tk.client for tk in tickets] == [0, 1]
    for tk in tickets:
        assert tk.size in svc.server.env.pool
        assert tk.intensity >= 1
        assert tk.deadline >= 50.0
        assert _teq(tk.ref_local, svc.server.global_by_size[tk.size])
    assert svc.inflight == 2
    assert svc.metrics.down_bytes > 0


def test_admission_rejects_inflight_and_busy_and_offline():
    av = AvailabilityModel(6, mean_on=20.0, mean_off=10.0, seed=0)
    svc = _build(availability=av, max_inflight=2)
    assert len(svc.dispatch([0, 1], now=0.0)) == 2
    assert svc.dispatch(0, now=0.0) == []          # already holds a ticket
    assert svc.dispatch(2, now=0.0) == []          # at capacity
    c = svc.metrics.counts
    assert c["reject_dispatch_inflight"] == 1
    assert c["reject_dispatch_busy"] == 1
    # an offline client is refused even with capacity free
    t_off = av.next_offline(3, 0.0, 1e6)
    svc.tickets.clear()
    assert not av.available(3, t_off + 1e-3)
    assert svc.dispatch(3, now=t_off + 1e-3) == []
    assert c["reject_dispatch_offline"] == 1


def test_submit_without_ticket_rejected():
    svc = _build()
    r = svc.submit(4, {"local": None, "lite": None}, now=0.0)
    assert not r.accepted and r.reason == "no_ticket"
    assert svc.metrics.counts["reject_submit_no_ticket"] == 1


def test_non_streaming_policy_refused():
    with pytest.raises(ValueError, match="sync"):
        _build(policy="sync")


# ---------------------------------------------------------------------- #
# streaming ingest
# ---------------------------------------------------------------------- #
def test_async_applies_every_arrival():
    svc = _build(policy="async")                   # buffer_m = 1
    (tk,) = svc.dispatch(0, now=0.0)
    before = svc.server.global_by_size[tk.size]
    r = svc.submit(0, synth_update(tk, seed=1), now=1.0)
    assert r.accepted and r.aggregated and r.version == 1
    assert not _teq(before, svc.server.global_by_size[tk.size])
    assert svc.records[-1]["n_updates"] == 1


def test_buffered_waits_for_m_arrivals():
    svc = _build(policy="buffered")                # buffer_m = 3
    tks = svc.dispatch([0, 1, 2], now=0.0)
    r0 = svc.submit(0, synth_update(tks[0], seed=1), now=1.0)
    r1 = svc.submit(1, synth_update(tks[1], seed=1), now=2.0)
    assert not r0.aggregated and not r1.aggregated and svc.version == 0
    r2 = svc.submit(2, synth_update(tks[2], seed=1), now=3.0)
    assert r2.aggregated and svc.version == 1
    assert svc.records[-1]["n_updates"] == 3


def test_staleness_counts_aggregations_since_dispatch():
    svc = _build(policy="async")
    (slow,) = svc.dispatch(0, now=0.0)             # will go stale
    for now in (1.0, 2.0):                         # two aggregations pass
        (tk,) = svc.dispatch(1, now=now)
        svc.submit(1, synth_update(tk, seed=2), now=now + 0.5)
    assert svc.version == 2
    r = svc.submit(0, synth_update(slow, seed=2), now=3.0)
    assert r.staleness == 2
    assert svc.metrics.staleness[2] == 1
    assert svc.records[-1]["staleness"] == [2]


def test_wave_feedback_fires_when_wave_resolves():
    svc = _build(policy="async")
    tks = svc.dispatch([0, 1], now=0.0)            # one wave, two slots
    svc.submit(0, synth_update(tks[0], seed=3), now=1.0)
    assert svc.metrics.counts.get("wave_done", 0) == 0
    n_hist = len(svc.server.history)
    svc.submit(1, synth_update(tks[1], seed=3), now=2.0)
    assert svc.metrics.counts["wave_done"] == 1
    assert len(svc.server.history) == n_hist + 1   # record_wave ran
    assert svc._waves == {}


def test_ticket_reference_survives_later_aggregations():
    """Tickets hold references to the dispatch-time global tensors, not
    copies: aggregation must build new trees and never write a global in
    place, or every open ticket's codec reference would move with it."""
    svc = _build(codec=make_codec("topk+int8", ratio=0.25, dense_min=64),
                 policy="async")
    (held,) = svc.dispatch(0, now=0.0)
    frozen = [t.clone() for t in tree_leaves([held.ref_local,
                                              held.ref_lite])]
    for i, now in enumerate((1.0, 2.0, 3.0)):
        (tk,) = svc.dispatch(1 + i, now=now)
        svc.submit(1 + i, synth_update(tk, seed=9), now=now + 0.5)
    assert svc.version == 3
    moved = tree_leaves([svc.server.global_by_size[held.size],
                         svc.server.lite_params])
    assert not all(torch.equal(a, b) for a, b in zip(frozen, moved))
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, tree_leaves([held.ref_local, held.ref_lite])))
    # and the stale update still decodes against the reference it was
    # dispatched with
    r = svc.submit(0, synth_update(held, seed=9), now=4.0)
    assert r.accepted and r.staleness == 3


# ---------------------------------------------------------------------- #
# churn
# ---------------------------------------------------------------------- #
def test_expiry_rejoin_cycle():
    svc = _build(policy="async", min_deadline=10.0)
    (tk,) = svc.dispatch(0, now=0.0)
    deadline = tk.deadline
    assert svc.poll(deadline - 1e-6) == 0          # not yet
    assert svc.poll(deadline + 1e-6) == 1          # churned away
    assert svc.inflight == 0
    assert svc.metrics.counts["expired"] == 1
    # a late submit against the expired ticket bounces
    late = svc.submit(0, synth_update(tk, seed=1), now=deadline + 1.0)
    assert not late.accepted and late.reason == "no_ticket"
    # the client coming back is the rejoin path
    assert len(svc.dispatch(0, now=deadline + 2.0)) == 1
    assert svc.metrics.counts["rejoin"] == 1
    # a wave whose every slot expired still resolves (RL feedback runs)
    assert svc.metrics.counts["wave_done"] == 1


def test_expired_slot_is_freed_for_other_clients():
    svc = _build(policy="async", max_inflight=1, min_deadline=10.0)
    (tk,) = svc.dispatch(0, now=0.0)
    assert svc.dispatch(1, now=1.0) == []          # capacity held by 0
    got = svc.dispatch(1, now=tk.deadline + 1.0)   # 0 expired -> slot free
    assert [t.client for t in got] == [1]


# ---------------------------------------------------------------------- #
# codec on the ingest path
# ---------------------------------------------------------------------- #
def test_codec_compresses_and_keeps_ef_residuals():
    codec = make_codec("topk+int8", ratio=0.25, dense_min=64)
    svc = _build(codec=codec, policy="async")
    (tk,) = svc.dispatch(0, now=0.0)
    dense_bytes = 4.0 * sum(x.numel() for x in tree_leaves(
        {"l": tk.ref_local, "t": tk.ref_lite}))
    r = svc.submit(0, synth_update(tk, seed=4), now=1.0)
    assert 0 < r.wire_bytes < 0.5 * dense_bytes
    assert svc.metrics.up_bytes == r.wire_bytes
    keys = set(svc.server._ef)
    assert (0, "local", tk.size) in keys and (0, "lite", "") in keys


def test_identity_codec_is_bit_exact_on_ingest():
    svc = _build(codec=make_codec("identity"), policy="async")
    (tk,) = svc.dispatch(0, now=0.0)
    upd = synth_update(tk, seed=5)
    decoded, _ = svc._ingest_decode(tk, upd)
    assert _teq(decoded, upd)


# ---------------------------------------------------------------------- #
# observability
# ---------------------------------------------------------------------- #
def test_metrics_dump_artifact(tmp_path):
    svc = _build(policy="async")
    (tk,) = svc.dispatch(0, now=0.0)
    svc.submit(0, synth_update(tk, seed=6), now=1.0)
    out = tmp_path / "m.json"
    svc.metrics.dump(out)
    doc = json.loads(out.read_text())
    snap = doc["snapshot"]
    assert snap["counts"]["dispatch"] == 1 and snap["counts"]["submit"] == 1
    assert snap["staleness_hist"] == {"0": 1}
    assert snap["dispatch"]["n"] == 1 and "p99_ms" in snap["dispatch"]
    kinds = [e["event"] for e in doc["events"]]
    assert kinds == ["dispatch", "submit", "aggregate", "wave_done"]


def test_reset_window_keeps_cumulative_counters():
    svc = _build(policy="async")
    (tk,) = svc.dispatch(0, now=0.0)
    svc.submit(0, synth_update(tk, seed=7), now=1.0)
    svc.metrics.reset_window()
    snap = svc.metrics.snapshot()
    assert snap["counts"]["submit"] == 1           # cumulative survives
    assert snap["window_counts"]["submit"] == 0    # window restarted
    assert snap["dispatch"] is None                # reservoir cleared


# ---------------------------------------------------------------------- #
# durability: the bit-identical kill/restore pin
# ---------------------------------------------------------------------- #
def _parity_build(codec_name, seed=0):
    codec = None if codec_name == "identity" else make_codec(
        codec_name, ratio=0.25, dense_min=64)
    av = AvailabilityModel(6, mean_on=30.0, mean_off=8.0, seed=1)
    return _build(codec=codec, policy="buffered", availability=av,
                  min_deadline=6.0, seed=seed)


def assert_same_service_state(ref, other):
    """Everything a restored service must carry over, bit for bit: globals,
    LiteModel, both PPO agents (params, AdamW state, buffer, pending
    transition, rewards), the generator, EF residuals, env rng, records,
    the deterministic metrics slice and the byte counts."""
    a, b = ref.server, other.server
    assert _teq(a.lite_params, b.lite_params)
    assert _teq(a.global_by_size, b.global_by_size)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    for oa, ob in ((a.allocator, b.allocator), (a.intensity, b.intensity)):
        assert _teq(oa.agent.params, ob.agent.params)
        assert _teq(oa.agent.opt_state, ob.agent.opt_state)
        assert len(oa.agent.buffer) == len(ob.agent.buffer)
        for ea, eb in zip(oa.agent.buffer, ob.agent.buffer):
            assert list(ea) == list(eb)
            assert all(np.asarray(ea[k]).dtype == np.asarray(eb[k]).dtype
                       and np.array_equal(ea[k], eb[k]) for k in ea)
        assert oa.agent.reward_history == ob.agent.reward_history
        assert set(oa._pending) == set(ob._pending)
        for k in oa._pending:
            assert np.array_equal(oa._pending[k], ob._pending[k])
        assert type(oa._pending.get("logprob")) is type(
            ob._pending.get("logprob"))
    assert sorted(a._ef) == sorted(b._ef)
    assert all(_teq(a._ef[k], b._ef[k]) for k in a._ef)
    assert a.env.rng.bit_generator.state == b.env.rng.bit_generator.state
    assert ref.version == other.version
    assert ref.records == other.records
    assert (ref.metrics.deterministic_counts()
            == other.metrics.deterministic_counts())
    assert dict(ref.metrics.staleness) == dict(other.metrics.staleness)
    assert ref.metrics.up_bytes == other.metrics.up_bytes
    assert ref.metrics.down_bytes == other.metrics.down_bytes


@pytest.mark.parametrize("codec_name", ["identity", "topk+int8"])
def test_checkpoint_restore_bit_identical(tmp_path, codec_name):
    """N events -> checkpoint -> kill -> restore -> the rest must equal the
    uninterrupted run bit for bit (assert_same_service_state)."""
    trace = poisson_trace(80, 6, 1.0, seed=3)
    cut = 37

    ref = _parity_build(codec_name)
    LoadGenerator(ref, trace, seed=5).replay()
    assert ref.server.allocator.agent.n_updates >= 1   # PPO updated

    first = _parity_build(codec_name)
    LoadGenerator(first, trace, seed=5).replay(stop=cut)
    path = first.checkpoint(str(tmp_path / "ck"))
    assert first.tickets and first._waves         # state in flight at the cut
    del first                                      # the "kill"

    second = _parity_build(codec_name)
    second.restore(path)
    LoadGenerator(second, trace, seed=5).replay(start=cut)
    assert_same_service_state(ref, second)


def test_restore_refuses_mismatched_config(tmp_path):
    svc = _build(policy="async")
    svc.dispatch(0, now=0.0)
    path = svc.checkpoint(str(tmp_path / "ck"))
    other = _build(codec=make_codec("topk+int8", ratio=0.25, dense_min=64),
                   policy="buffered")
    with pytest.raises(ValueError, match="codec"):
        other.restore(path)


def test_auto_checkpoint_and_latest(tmp_path):
    svc = _build(policy="async", checkpoint_dir=str(tmp_path),
                 checkpoint_every=1)
    for now in (0.0, 5.0):
        (tk,) = svc.dispatch(0, now=now)
        svc.submit(0, synth_update(tk, seed=8), now=now + 1.0)
    assert latest_checkpoint(tmp_path) == str(tmp_path / "ckpt-00000002")
    assert svc.metrics.counts["checkpoint"] == 2
    assert latest_checkpoint(tmp_path / "nope") is None


# ---------------------------------------------------------------------- #
# against the reference ParamService
# ---------------------------------------------------------------------- #
def _pair(policy, seed=0, **svc_kw):
    """The reference's service and the port's on the CPU, PPO off, the
    port's globals the reference's."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(seed=seed,
                                                             **CFG)),
                           seed=seed, use_ppo1=False, use_ppo2=False)
    srv = _server(seed, use_ppo1=False, use_ppo2=False)
    conv = lambda t: params_from_numpy(jax.device_get(t), "cpu")
    srv.lite_params = conv(jsrv.lite_params)
    srv.global_by_size = {s: conv(p) for s, p in jsrv.global_by_size.items()}
    out = []
    for mod, s in ((jservice, jsrv), (None, srv)):
        av = (JAvailabilityModel if mod else AvailabilityModel)(
            6, mean_on=30.0, mean_off=8.0, seed=1)
        make = mod.ParamService if mod else ParamService
        out.append(make(s, policy=policy, availability=av, min_deadline=6.0,
                        **svc_kw))
    return out


def _assert_globals_close(jsvc, svc):
    got = {"lite": svc.server.lite_params, **svc.server.global_by_size}
    exp = {"lite": jsvc.server.lite_params, **jsvc.server.global_by_size}
    for name in exp:
        flat_e = dict(jax.tree_util.tree_flatten_with_path(exp[name])[0])
        flat_g = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda t: t.numpy(), got[name]))[0]
        assert len(flat_g) == len(flat_e)
        for path, g in flat_g:
            np.testing.assert_allclose(g, np.asarray(flat_e[path]),
                                       atol=GLOBALS_ATOL, rtol=0)


@pytest.mark.parametrize("policy", ["async", "buffered"])
def test_host_records_match_reference_service(policy):
    """PPO off, churn on, the same trace: the same event log (every
    dispatch, submit, expiry, rejoin and aggregation, with its client,
    wave, size, intensity, deadline, staleness and wire bytes), records,
    counters and bytes as the reference's service; globals at 1e-5."""
    trace = poisson_trace(80, 6, 1.0, seed=3)
    jsvc, svc = _pair(policy)
    jservice.LoadGenerator(jsvc, trace, seed=5).replay()
    LoadGenerator(svc, trace, seed=5).replay()
    assert svc.records and svc.metrics.counts["expired"] > 0
    assert list(svc.metrics.events) == list(jsvc.metrics.events)
    assert svc.records == jsvc.records
    assert (svc.metrics.deterministic_counts()
            == jsvc.metrics.deterministic_counts())
    assert dict(svc.metrics.staleness) == dict(jsvc.metrics.staleness)
    assert svc.metrics.up_bytes == jsvc.metrics.up_bytes
    assert svc.metrics.down_bytes == jsvc.metrics.down_bytes
    assert svc._churned_clients() == jsvc._churned_clients()
    _assert_globals_close(jsvc, svc)


def test_synth_update_is_bitwise_the_reference():
    """From equal references the update is the reference's bits: the same
    numpy noise stream, drawn in jax.tree_util's leaf order."""
    jsvc, svc = _pair("async")
    (jtk,) = jsvc.dispatch(2, now=0.0)
    (tk,) = svc.dispatch(2, now=0.0)
    assert (tk.client, tk.version, tk.wave) == (jtk.client, jtk.version,
                                                jtk.wave)
    exp = jservice.synth_update(jtk, scale=1e-3, seed=4)
    got = synth_update(tk, scale=1e-3, seed=4)
    assert _by_path_equal(got, params_from_numpy(exp, "cpu"))
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))


def test_restore_refuses_the_other_package_snapshot(tmp_path):
    """Service snapshots do not cross packages (the reference's carries a
    JAX PRNG key, the port's its generator's state): the port refuses the
    reference's before touching the service, and the reference's restore
    stops at the missing key before it writes anything."""
    jsvc, svc = _pair("async")
    jsvc.dispatch(0, now=0.0)
    svc.dispatch(0, now=0.0)
    jpath = jsvc.checkpoint(str(tmp_path / "ref"))
    path = svc.checkpoint(str(tmp_path / "port"))
    fresh = _pair("async")[1]
    before = [t.clone() for t in tree_leaves(fresh.server.global_by_size)]
    with pytest.raises(ValueError, match="another package"):
        fresh.restore(jpath)
    assert fresh.version == 0 and not fresh.tickets
    assert _teq(before, tree_leaves(fresh.server.global_by_size))
    jfresh = _pair("async")[0]
    with pytest.raises(KeyError, match="server/key"):
        jfresh.restore(path)
    assert jfresh.version == 0 and not jfresh.tickets


def test_serve_main_runs_and_resumes_on_cpu(tmp_path, capsys):
    """launch/serve.py's entry point with --device cpu: about 40 events
    with the health report, Prometheus and JSONL outputs and a checkpoint
    directory; a second run with the same directory resumes from the
    newest checkpoint and carries the counters on."""
    from repro_torch.launch.serve import main
    d = tmp_path / "ck"
    argv = ["--n-clients", "8", "--events", "40", "--codec", "topk+int8",
            "--device", "cpu", "--checkpoint-dir", str(d),
            "--checkpoint-every", "3",
            "--metrics-out", str(tmp_path / "m.json")]
    svc = main(argv + ["--health-report", str(tmp_path / "h.md"),
                       "--prom-out", str(tmp_path / "m.prom"),
                       "--events-jsonl", str(tmp_path / "e.jsonl")])
    out = capsys.readouterr().out
    assert "resumed" not in out and "final checkpoint" in out
    assert svc.version > 0 and svc.server.device.type == "cpu"
    for name in ("m.json", "h.md", "h.json", "m.prom", "e.jsonl"):
        assert (tmp_path / name).stat().st_size > 0, name
    first = latest_checkpoint(d)
    assert first == str(d / f"ckpt-{svc.version:08d}")
    again = main(argv)
    out = capsys.readouterr().out
    assert f"resumed from {first} at version {svc.version}" in out
    assert again.version > svc.version
    assert (again.metrics.counts["submit"]
            > svc.metrics.counts["submit"])
    assert sorted(os.listdir(d))[-1] == f"ckpt-{again.version:08d}.npz"
