"""The port's service-side telemetry on the CPU: the metrics registry
(repro_torch.obs.registry), SLOs (.slo), Prometheus / JSONL export
(.export), the fleet health report (.report) and ServiceMetrics
(repro_torch.service.metrics) — the registry, export, Prometheus, SLO,
report and dump tests of tests/test_obs.py and tests/test_health.py on the
port, and the exposition and report byte-identical to the reference's for
the same inputs. Everything here is host Python and numpy; no tolerance
beyond the reference tests' own."""
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import export as jexport, health as jhealth, report as jreport
from repro.obs import registry as jregistry, slo as jslo
from repro_torch.core.latency import AvailabilityModel
from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
from repro_torch.obs import export as texport, health as thealth
from repro_torch.obs import registry as tregistry, report as treport
from repro_torch.obs import slo as tslo
from repro_torch.obs.export import (JsonlEventLog, parse_prometheus_text,
                                    prometheus_text, write_prometheus)
from repro_torch.obs.health import PHASES, FleetHealth
from repro_torch.obs.registry import (Counter, CounterVec, Gauge, Histogram,
                                      IntHistogram, MetricsRegistry,
                                      Reservoir, latency_stats)
from repro_torch.obs.report import fleet_health_report, write_health_report
from repro_torch.obs.slo import (SLO, SLOSet, default_service_slos,
                                 default_sim_slos)
from repro_torch.service import LoadGenerator, ParamService, poisson_trace
from repro_torch.service.metrics import ServiceMetrics
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dataset="mnist", n_train=300, n_test=80, n_clients=8,
           k_per_round=4, batches_per_epoch=1, default_epochs=2,
           batch_size=16)


# --------------------------------------------------------------------- #
# metrics registry
# --------------------------------------------------------------------- #
def test_registry_instruments_roundtrip():
    r = MetricsRegistry()
    r.counter("c").inc(2.5)
    r.counter_vec("cv").inc("a", 3)
    r.gauge("g").set(7.0)
    r.int_histogram("ih").observe(4)
    h = r.histogram("h", edges=(1.0, 10.0))
    h.observe(0.5), h.observe(5.0), h.observe(50.0)
    r.reservoir("res").observe(0.25)
    state = r.pack()
    assert "res" not in state                 # reservoirs excluded by default
    assert state == {"c": 2.5, "cv": {"a": 3}, "g": 7.0, "ih": {"4": 1},
                     "h": {"edges": [1.0, 10.0], "buckets": [1, 1, 1],
                           "sum": 55.5, "count": 3}}
    r2 = MetricsRegistry()
    r2.counter("c"), r2.counter_vec("cv"), r2.gauge("g")
    r2.int_histogram("ih"), r2.histogram("h", edges=(1.0, 10.0))
    r2.unpack(state)
    assert r2.pack() == state
    assert json.dumps(r2.pack(), sort_keys=True) == \
        json.dumps(state, sort_keys=True)
    assert {type(r[n]) for n in r.names()} == {
        Counter, CounterVec, Gauge, IntHistogram, Histogram, Reservoir}


def test_registry_get_or_create_and_kind_mismatch():
    r = MetricsRegistry()
    c = r.counter("x")
    assert r.counter("x") is c
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("x")
    with pytest.raises(KeyError, match="unknown instrument"):
        r.unpack({"nope": 1})
    assert "x" in r and r["x"] is c and r.names() == ["x"]


def test_histogram_edge_mismatch_and_reservoir_bound():
    h = Histogram("h", edges=(1.0, 2.0))
    with pytest.raises(ValueError, match="edge mismatch"):
        h.unpack({"edges": [1.0, 3.0], "buckets": [0, 0, 0], "sum": 0.0,
                  "count": 0})
    with pytest.raises(ValueError, match="sorted"):
        Histogram("bad", edges=(2.0, 1.0))
    res = Reservoir("r", maxlen=4)
    for i in range(10):
        res.observe(float(i))
    assert list(res.samples) == [6.0, 7.0, 8.0, 9.0]
    assert res.stats()["n"] == 4
    assert latency_stats([]) is None


# --------------------------------------------------------------------- #
# ServiceMetrics: the reference's schema + dump determinism
# --------------------------------------------------------------------- #
def _exercised_metrics():
    m = ServiceMetrics()
    m.bump("dispatch", 3)
    m.bump("submit", 2)
    m.bump("checkpoint")          # LOCAL_COUNT_KEYS: not checkpointed
    m.note_staleness(0)
    m.note_staleness(2)
    m.up_bytes += 123.456
    m.down_bytes += 7.0
    m.dispatch_s.append(0.001)
    m.submit_s.append(0.002)
    m.log(1.5, "dispatch", client=4)
    return m


def test_service_metrics_pack_schema_unchanged():
    """pack() emits the reference's structure, which service checkpoints
    carry in their aux json."""
    m = _exercised_metrics()
    state = m.pack()
    assert sorted(state) == ["counts", "down_bytes", "staleness", "up_bytes"]
    assert state["counts"] == {"dispatch": 3, "submit": 2}   # no 'checkpoint'
    assert state["staleness"] == {"0": 1, "2": 1}
    assert isinstance(state["up_bytes"], float)
    m2 = ServiceMetrics()
    m2.unpack(json.loads(json.dumps(state)))      # via-JSON round trip
    assert json.dumps(m2.pack(), sort_keys=True) == \
        json.dumps(state, sort_keys=True)


def test_service_metrics_snapshot_keys_match_committed_artifact():
    """The snapshot surface keeps the keys recorded in the committed
    serve_load artifact (read only)."""
    art = Path(__file__).resolve().parents[1] / "artifacts" / "bench" / \
        "serve_load.json"
    row = next(iter(json.loads(art.read_text()).values()))
    snap = _exercised_metrics().snapshot()
    for key in ("updates_per_sec", "aggregations_per_sec", "staleness_hist",
                "dispatch", "submit", "checkpoint", "up_bytes",
                "down_bytes"):
        assert key in snap and key in row
    assert snap["dispatch"]["n"] == 1


def test_dump_is_byte_deterministic(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 42.0)
    m = _exercised_metrics()
    m.snapshot()["counts"]["dispatch"]            # reads don't mutate
    m.dump(tmp_path / "a.json")
    m.dump(tmp_path / "b.json")
    a = (tmp_path / "a.json").read_bytes()
    assert a == (tmp_path / "b.json").read_bytes()
    m2 = _exercised_metrics()
    m2.dump(tmp_path / "c.json")
    assert a == (tmp_path / "c.json").read_bytes()
    data = json.loads(a)
    assert list(data) == ["events", "snapshot"]
    assert data["snapshot"]["up_bytes"] == 123.5   # round(…, 1) at source


def test_dump_rejects_non_json_types(tmp_path):
    m = ServiceMetrics()
    m.events.append({"t": 0.0, "event": "bad", "arr": np.arange(3)})
    with pytest.raises(TypeError, match="non-JSON-serializable"):
        m.dump(tmp_path / "x.json")
    m.events.clear()
    m.log(0.0, "ok", v=float(np.float64(1.25)))
    m.events.append({"t": 0.0, "event": "ok2", "v": np.float32(0.5)})
    m.dump(tmp_path / "y.json")
    assert json.loads((tmp_path / "y.json").read_text())


def test_prometheus_matches_dump_for_deterministic_counters():
    m = _exercised_metrics()
    parsed = parse_prometheus_text(m.prometheus())
    counts = parsed["hapfl_service_counts_total"]
    for key, v in m.deterministic_counts().items():
        assert counts[(("key", key),)] == float(v), key
    snap = m.snapshot()
    assert parsed["hapfl_service_up_bytes"][()] == m.up_bytes
    assert parsed["hapfl_service_down_bytes"][()] == m.down_bytes
    stal = parsed["hapfl_service_staleness_bucket"]
    assert stal[(("le", "+Inf"),)] == \
        sum(int(v) for v in snap["staleness_hist"].values())
    assert m.prometheus() == m.prometheus()


# --------------------------------------------------------------------- #
# SLOs + burn rate
# --------------------------------------------------------------------- #
def test_slo_validation():
    with pytest.raises(ValueError, match="op"):
        SLO("x", "m", op="<")
    with pytest.raises(ValueError, match="objective"):
        SLO("x", "m", objective=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        SLOSet([SLO("x", "m"), SLO("x", "m2")])


def test_burn_rate_status_transitions():
    s = SLOSet([SLO("lat", "g", "value", "<=", 10.0, objective=0.9,
                    window=10)])
    r = MetricsRegistry()
    g = r.gauge("g")
    g.set(5.0)
    row = s.evaluate(registry=r)[0]
    assert row["status"] == "ok" and row["burn_rate"] == 0.0
    g.set(50.0)                      # 1 breach / 10 / 0.1 = burn 1.0
    row = s.evaluate(registry=r)[0]
    assert row["status"] == "warn" and row["burn_rate"] == 1.0
    row = s.evaluate(registry=r)[0]  # 2 breaches -> burn 2.0
    assert row["status"] == "breach" and row["burn_rate"] == 2.0
    assert s.worst_status() == "breach"
    assert s.report()[0]["breaches"] == 2 and s.report()[0]["checks"] == 3


def test_no_data_consumes_no_budget():
    s = SLOSet([SLO("lat", "service.dispatch_s", "p99", "<=", 1.0)])
    row = s.evaluate(registry=MetricsRegistry())[0]
    assert row["status"] == "no_data" and row["value"] is None
    assert row["burn_rate"] == 0.0 and row["checks"] == 0
    assert s.worst_status() == "no_data"


def test_slo_measures_registry_instruments():
    r = MetricsRegistry()
    res = r.reservoir("lat_s")
    for v in (0.010, 0.020, 0.030):
        res.observe(v)
    r.counter_vec("counts").inc("expired", 4)
    r.int_histogram("stale").observe(2)
    r.int_histogram("stale").observe(6)
    rows = SLOSet([
        SLO("p99", "lat_s", "p99", "<=", 100.0),
        SLO("exp", "counts", "key:expired", "<=", 3.0),
        SLO("tau", "stale", "p95", "<=", 8.0),
    ]).evaluate(registry=r)
    assert rows[0]["value"] == pytest.approx(
        float(np.percentile([10.0, 20.0, 30.0], 99)))
    assert rows[1]["value"] == 4.0 and rows[1]["met"] is False
    assert rows[2]["value"] == 6.0 and rows[2]["met"] is True


def test_slo_measures_sim_result():
    class Rec:
        def __init__(self, s, n):
            self.straggling, self.n_updates = s, n

    class Result:
        records = [Rec(5.0, 2), Rec(100.0, 0), Rec(7.0, 1)]
        time_to_target = 42.0

    rows = SLOSet([
        SLO("strag", "records.straggling", "max", "<=", 10.0),
        SLO("ttt", "result.time_to_target", "value", "<=", 50.0),
    ]).evaluate(result=Result())
    assert rows[0]["value"] == 7.0 and rows[0]["met"] is True
    assert rows[1]["value"] == 42.0 and rows[1]["met"] is True


def test_default_slo_sets():
    names = [s.name for s in default_service_slos().slos]
    assert names == ["dispatch_p99_ms", "submit_p99_ms", "staleness_p95"]
    assert [s.name for s in default_sim_slos().slos] == ["straggling_p95"]
    assert [s.name for s in default_sim_slos(time_to_target=10.0).slos] \
        == ["straggling_p95", "time_to_target_s"]


# --------------------------------------------------------------------- #
# Prometheus exposition + JSONL stream
# --------------------------------------------------------------------- #
def _exercised_registry(registry=tregistry):
    r = registry.MetricsRegistry()
    r.counter("service.agg").inc(3)
    cv = r.counter_vec("service.counts")
    cv.inc("dispatch", 5), cv.inc("submit", 2)
    r.gauge("service.up_bytes").set(123.5)
    r.gauge("slo.x.burn_rate").set(float("inf"))
    ih = r.int_histogram("service.staleness")
    ih.observe(0), ih.observe(0), ih.observe(3)
    h = r.histogram("lat", edges=(0.1, 1.0))
    h.observe(0.05), h.observe(0.5), h.observe(2.0)
    res = r.reservoir("service.dispatch_s")
    for v in (0.001, 0.002, 0.004):
        res.observe(v)
    return r


def test_prometheus_round_trip_and_stability():
    r = _exercised_registry()
    text = prometheus_text(r)
    assert text == prometheus_text(r)            # byte-stable
    parsed = parse_prometheus_text(text)
    assert parsed["hapfl_service_agg_total"][()] == 3.0
    assert parsed["hapfl_service_counts_total"][(("key", "dispatch"),)] == 5.0
    assert parsed["hapfl_service_up_bytes"][()] == 123.5
    ih = parsed["hapfl_service_staleness_bucket"]
    assert ih[(("le", "0.0"),)] == 2.0 and ih[(("le", "+Inf"),)] == 3.0
    assert parsed["hapfl_service_staleness_count"][()] == 3.0
    lat = parsed["hapfl_lat_bucket"]
    assert lat[(("le", "0.1"),)] == 1.0 and lat[(("le", "+Inf"),)] == 3.0
    q = parsed["hapfl_service_dispatch_s"]
    assert (("quantile", "0.5"),) in q
    assert parsed["hapfl_service_dispatch_s_count"][()] == 3.0


def test_prometheus_const_labels_and_sanitization(tmp_path):
    r = MetricsRegistry()
    r.counter("weird-name.with:stuff").inc(1)
    text = prometheus_text(r, namespace="ns",
                           const_labels={"run": "a b\"c\\d\n"})
    parsed = parse_prometheus_text(text)
    [(name, series)] = parsed.items()
    assert name == "ns_weird_name_with:stuff_total"
    [(labels, v)] = series.items()
    assert labels == (("run", 'a b"c\\d\n'),) and v == 1.0
    p = write_prometheus(r, tmp_path / "m.prom", namespace="ns",
                         const_labels={"run": 'a b"c\\d\n'})
    assert parse_prometheus_text(p.read_text()) == parsed


def test_prometheus_rejects_nonfinite_and_orders_labels():
    r = MetricsRegistry()
    r.gauge("g").set(float("inf"))
    text = prometheus_text(r)
    assert "hapfl_g +Inf" in text
    cv = r.counter_vec("v")
    cv.inc("zz"), cv.inc("aa")
    lines = [ln for ln in prometheus_text(r).splitlines()
             if ln.startswith("hapfl_v_total")]
    assert lines == sorted(lines)                # deterministic label order


def test_prometheus_text_is_the_reference_bytes():
    """The same instruments fed the same values in each package's registry
    expose the same bytes, with and without constant labels."""
    port = _exercised_registry(tregistry)
    ref = _exercised_registry(jregistry)
    assert texport.prometheus_text(port) == jexport.prometheus_text(ref)
    labels = {"run": 'a "b"', "host": "h\n1"}
    assert (texport.prometheus_text(port, namespace="ns",
                                     const_labels=labels)
            == jexport.prometheus_text(ref, namespace="ns",
                                       const_labels=labels))


def test_jsonl_event_log_rotation(tmp_path):
    path = tmp_path / "ev.jsonl"
    log = JsonlEventLog(path, max_bytes=200, max_files=2)
    for i in range(50):
        log.write({"t": float(i), "event": "tick", "i": i})
    log.close()
    assert log.n_written == 50 and log.n_rotations > 0
    rotated = sorted(p.name for p in tmp_path.glob("ev.jsonl*"))
    assert path.exists() and f"{path.name}.1" in rotated
    assert f"{path.name}.{log.max_files + 1}" not in rotated  # bounded
    for p in tmp_path.glob("ev.jsonl*"):
        for line in p.read_text().splitlines():
            ev = json.loads(line)
            assert ev["event"] == "tick"
            assert list(ev) == sorted(ev)        # sorted keys on the wire


def test_jsonl_context_manager(tmp_path):
    with JsonlEventLog(tmp_path / "x.jsonl") as log:
        log.write({"a": 1})
    assert (tmp_path / "x.jsonl").read_text() == '{"a":1}\n'


# --------------------------------------------------------------------- #
# report generator
# --------------------------------------------------------------------- #
def _toy_health(health=thealth):
    h = health.FleetHealth(3)
    h.note_outcome("dispatched", 2)
    h.note_wave(0, 0.0, 4.0, [0, 1], ["small", "large"], [0.1, 0.2],
                [1.0, 3.0], [0.2, 0.5])
    h.note_wave(1, 4.0, 5.5, [2], ["small"], [0.3], [0.4], [0.1])
    h.note_outcome("expired")
    h.note_rl(0, {"ppo1": {"entropy": 1.2, "reward": -0.5,
                           "n_updates": 0.0}})
    return h


def _toy_slos(slo=tslo, registry=tregistry):
    s = slo.SLOSet([slo.SLO("lat", "g", "value", "<=", 10.0),
                    slo.SLO("tau", "stale", "p95", "<=", 1.0)])
    r = registry.MetricsRegistry()
    r.gauge("g").set(3.0)
    r.int_histogram("stale").observe(4)
    s.evaluate(registry=r)
    return s


def test_report_renders_attribution_and_slos(tmp_path):
    md, data = fleet_health_report(
        [{"label": "toy run", "health": _toy_health(), "slo": _toy_slos(),
          "meta": {"seed": 0}}])
    assert "# HAPFL fleet health report" in md and "## toy run" in md
    assert "**local**" in md                  # dominant phase, bolded
    assert "| lat | 3 | 10" in md
    sec = data["sections"][0]
    assert sec["health"]["waves"][0]["dominant_phase"] == "local"
    assert sec["slo"][0]["status"] == "ok"


def test_write_health_report_sibling_json(tmp_path):
    md_path, json_path = write_health_report(
        tmp_path / "r.md", [{"label": "x", "health": _toy_health()}])
    assert md_path.read_text().startswith("# HAPFL fleet health report")
    data = json.loads(json_path.read_text())
    assert data["sections"][0]["label"] == "x"
    md2, _ = fleet_health_report(
        [{"label": "x", "health": _toy_health().summary()}])
    assert md2 == md_path.read_text()


def test_fleet_health_report_is_the_reference_bytes(tmp_path):
    """The same waves, outcomes, RL rows and SLO checks, fed to each
    package's FleetHealth and SLOSet, render the same markdown and the same
    JSON, and write the same two files."""
    def sections(health, slo, registry):
        return [{"label": "toy run", "health": _toy_health(health),
                 "slo": _toy_slos(slo, registry),
                 "meta": {"seed": 0, "policy": "async"}},
                {"label": "summary only",
                 "health": _toy_health(health).summary()}]
    md, data = treport.fleet_health_report(
        sections(thealth, tslo, tregistry))
    jmd, jdata = jreport.fleet_health_report(
        sections(jhealth, jslo, jregistry))
    assert md == jmd
    assert json.dumps(data, sort_keys=True) == json.dumps(jdata,
                                                          sort_keys=True)
    paths = treport.write_health_report(tmp_path / "t.md",
                                        sections(thealth, tslo, tregistry))
    jpaths = jreport.write_health_report(tmp_path / "j.md",
                                         sections(jhealth, jslo, jregistry))
    for p, q in zip(paths, jpaths):
        assert Path(p).read_bytes() == Path(q).read_bytes()


# --------------------------------------------------------------------- #
# integration: the service's SLO gauges and health
# --------------------------------------------------------------------- #
def test_service_slo_gauges_and_health():
    srv = HAPFLServer(FLEnvironment(FLSimConfig(**CFG)), seed=0,
                      device="cpu")
    av = AvailabilityModel(CFG["n_clients"], mean_on=10.0, mean_off=5.0,
                           seed=0)
    svc = ParamService(srv, policy="async", availability=av,
                       max_inflight=4, min_deadline=6.0, health=True,
                       slos=default_service_slos(
                           dispatch_p99_ms=60_000.0,
                           submit_p99_ms=60_000.0, staleness_p95=64.0),
                       slo_every=2.0)
    assert srv.collect_rl_diag is True
    trace = poisson_trace(60, CFG["n_clients"], 2.0, seed=0)
    LoadGenerator(svc, trace, seed=0).replay()
    rows = svc.slos.report()
    reg = svc.metrics.registry
    checked = [r for r in rows if r["checks"] > 0]
    assert checked
    for r in checked:
        assert reg[f"slo.{r['name']}.burn_rate"].value >= 0.0
        assert reg[f"slo.{r['name']}.ok"].value in (0.0, 1.0)
    assert svc.metrics.counts[f"slo_{svc.slos.worst_status()}"] >= 1
    s = svc.health.summary(store=svc.store)
    assert s["n_waves"] >= 1
    for row in s["waves"]:
        assert row["dominant_phase"] in PHASES
        assert math.isclose(sum(row["phases_s"].values()), row["span_s"],
                            rel_tol=1e-6, abs_tol=1e-3)
    assert s["rl"] and set(s["rl"][0]) >= {"wave", "ppo1", "ppo2"}
    assert any(e["event"] == "slo" for e in svc.metrics.events)
    assert isinstance(svc.health, FleetHealth)
