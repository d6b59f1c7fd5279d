"""Event-driven asynchronous FL simulation (DESIGN.md §10).

A virtual-clock discrete-event scheduler drives the HAPFL server's
wave-level callbacks through client events (assessment-done, upload-done,
dropout, rejoin) under pluggable aggregation policies: `sync` (round
barrier — reproduces `HAPFLServer.run` byte-for-byte), `deadline`
(aggregate whoever finishes in time, drop the rest), `buffered`
(FedBuff-style semi-async with staleness-discounted weights), and `async`
(apply-on-arrival).
"""
from repro_torch.sim.events import (ARRIVAL, ASSESS_DONE, DEADLINE,
                                    DROPOUT, REJOIN, Event, EventQueue)
from repro_torch.sim.policies import (AsyncPolicy, BufferedPolicy,
                                      DeadlinePolicy, SyncPolicy,
                                      make_policy)
from repro_torch.sim.scheduler import AggRecord, EventScheduler, SimResult
