"""Long-running parameter service (DESIGN.md §14).

Turns the event-driven simulator's policies into a deployable system: a
`ParamService` accepts dispatch requests and update submissions as they
arrive (apply-on-arrival streaming aggregation with staleness weights and
codec decode + error feedback on the ingest path), detects churned
clients via deadline timeouts driven by `AvailabilityModel`, checkpoints
and restores its full state bit-identically (`snapshot`), and exposes a
structured-log + rolling-counter observability surface (`metrics`). The
`loadgen` module replays Poisson client-arrival traces against it. The
globals, tickets and PPO agents live on the server's device; the service
itself trains nothing, so it launches none of the port's kernels.
"""
from repro_torch.service.loadgen import (LoadGenerator, TraceEvent,
                                         poisson_trace, synth_update)
from repro_torch.service.metrics import ServiceMetrics, latency_stats
from repro_torch.service.service import (STREAMING_POLICIES, ParamService,
                                         SubmitReceipt, Ticket)
from repro_torch.service.snapshot import (latest_checkpoint,
                                          restore_service, save_service)
