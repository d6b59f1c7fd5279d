"""Telemetry: the dual-clock span tracer (`repro_torch.obs.trace`), per-wave
PPO diagnostics (`repro_torch.obs.rl`) and fleet health analytics —
straggler phase attribution, EWMA drift, churn (`repro_torch.obs.health`).
The rest of ``repro.obs`` (registry, SLOs, export, report) is ported with
the parameter service."""
from repro_torch.obs.health import FleetHealth
from repro_torch.obs.trace import (NULL_TRACER, VIRTUAL, WALL, NullTracer,
                                   Tracer, current, disable, enable,
                                   validate_chrome_trace,
                                   wave_timing_summary)
