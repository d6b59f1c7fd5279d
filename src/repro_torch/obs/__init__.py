"""Telemetry: the dual-clock span tracer (`repro_torch.obs.trace`). The rest
of ``repro.obs`` is ported in a later slice."""
from repro_torch.obs.trace import (NULL_TRACER, VIRTUAL, WALL, NullTracer,
                                   Tracer, current, disable, enable,
                                   validate_chrome_trace)
