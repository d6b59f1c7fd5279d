"""Aggregation policies for the event-driven simulator (DESIGN.md §10).

|          | aggregates when          | who                    | weights            |
|----------|--------------------------|------------------------|--------------------|
| sync     | wave barrier             | whole wave             | Eq. 38             |
| deadline | dispatch + deadline      | finishers; rest dropped| Eq. 38             |
| buffered | every `buffer_m` arrivals| the buffer (cross-wave)| Eq. 38 x staleness |
| async    | every arrival            | that update            | Eq. 38 x staleness, server mix |

Every policy composes with both server aggregation modes: under
`HAPFLServer(aggregation="cross_size")` each aggregation event feeds every
size's shared parameter slices (coverage-weighted, DESIGN.md §12) instead
of only the update's own size group, and the staleness tags above flow
into the per-slice coverage weights unchanged.

`sync` must reproduce `HAPFLServer.run` exactly (tests/test_torch_sim.py).
`deadline`'s deadline is a quantile of the wave's predicted finish offsets
(or a fixed horizon); over-provisioning is expressed by running it with a
larger `k_per_round` than the sync baseline. `buffered`/`async` keep the
server's in-flight population topped up to `k_per_round`, so fast clients
re-enlist while stragglers are still computing — their late updates arrive
with staleness tau = (aggregations since dispatch) and are discounted by
(1+tau)^-a (core.aggregation.staleness_discount). `async` additionally
applies a server mixing rate `mix` (a lone normalized update would
otherwise fully replace the global model).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SyncPolicy:
    name: str = "sync"


@dataclass(frozen=True)
class DeadlinePolicy:
    name: str = "deadline"
    quantile: float = 0.6          # deadline = quantile of predicted finishes
    fixed: Optional[float] = None  # absolute seconds per wave (overrides)


@dataclass(frozen=True)
class BufferedPolicy:
    name: str = "buffered"
    buffer_m: int = 3
    staleness_exponent: float = 0.5
    mix: float = 1.0


@dataclass(frozen=True)
class AsyncPolicy:
    name: str = "async"
    buffer_m: int = 1
    staleness_exponent: float = 0.5
    mix: float = 0.5


def make_policy(name: str, **kw):
    cls = {"sync": SyncPolicy, "deadline": DeadlinePolicy,
           "buffered": BufferedPolicy, "async": AsyncPolicy}.get(name)
    if cls is None:
        raise ValueError(f"unknown policy {name!r}")
    return cls(**kw)
