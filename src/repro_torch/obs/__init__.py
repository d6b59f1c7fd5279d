"""Telemetry: dual-clock span tracing with Perfetto export
(`repro_torch.obs.trace`), the general metrics registry `ServiceMetrics` is
built on (`repro_torch.obs.registry`), per-wave PPO diagnostics
(`repro_torch.obs.rl`), fleet health analytics — straggler phase
attribution, EWMA drift, churn (`repro_torch.obs.health`) — declarative SLOs
with burn-rate status (`repro_torch.obs.slo`), Prometheus text exposition +
JSONL event streams (`repro_torch.obs.export`), and the markdown/JSON fleet
health report (`repro_torch.obs.report`)."""
from repro_torch.obs.export import (JsonlEventLog, parse_prometheus_text,
                                    prometheus_text, write_prometheus)
from repro_torch.obs.health import FleetHealth
from repro_torch.obs.registry import (Counter, CounterVec, Gauge, Histogram,
                                      IntHistogram, MetricsRegistry,
                                      Reservoir, latency_stats)
from repro_torch.obs.report import fleet_health_report, write_health_report
from repro_torch.obs.slo import (SLO, SLOSet, default_service_slos,
                                 default_sim_slos)
from repro_torch.obs.trace import (NULL_TRACER, VIRTUAL, WALL, NullTracer,
                                   Tracer, current, disable, enable,
                                   validate_chrome_trace,
                                   wave_timing_summary)

__all__ = [
    "Counter", "CounterVec", "Gauge", "Histogram", "IntHistogram",
    "MetricsRegistry", "Reservoir", "latency_stats",
    "NULL_TRACER", "VIRTUAL", "WALL", "NullTracer", "Tracer",
    "current", "disable", "enable", "validate_chrome_trace",
    "wave_timing_summary",
    "FleetHealth", "SLO", "SLOSet", "default_service_slos",
    "default_sim_slos", "JsonlEventLog", "prometheus_text",
    "parse_prometheus_text", "write_prometheus", "fleet_health_report",
    "write_health_report",
]
