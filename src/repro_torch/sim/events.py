"""Deterministic discrete-event machinery for the FL simulator.

Events order by a *canonical* key — (time, kind priority, client, wave) —
not by queue insertion order, so the pop sequence (and therefore the whole
simulation) is invariant to how ties happen to be pushed
(tests/test_sim.py permutes insertions and asserts this for the
reference's copy of this module).

Kind priorities encode the tie-break semantics at one instant:
an arrival exactly at a deadline still counts (ARRIVAL < DEADLINE), and a
client that finishes the moment it would drop offline delivers its update
(ARRIVAL < DROPOUT).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

ASSESS_DONE = "assess_done"
ARRIVAL = "arrival"       # upload-done: the client's update reaches the server
DEADLINE = "deadline"
DROPOUT = "dropout"
REJOIN = "rejoin"

_PRIORITY = {ASSESS_DONE: 0, ARRIVAL: 1, DEADLINE: 2, DROPOUT: 3, REJOIN: 4}


@dataclass(frozen=True, order=True)
class Event:
    time: float
    kind: str
    client: int = -1
    wave: int = -1

    def sort_key(self):
        return (self.time, _PRIORITY[self.kind], self.client, self.wave)


class EventQueue:
    """Min-heap over Event.sort_key; push order never affects pop order."""

    def __init__(self):
        self._heap = []

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.sort_key(), ev))

    def push_batch(self, events) -> None:
        """Push a whole wave's events at once. When the batch rivals the
        heap in size, extend + heapify is O(n + m) against m pushes'
        O(m log n); pop order is canonical either way (the permutation
        test in tests/test_population.py pins batch == sequential)."""
        items = [(ev.sort_key(), ev) for ev in events]
        if len(items) > max(len(self._heap), 8):
            self._heap.extend(items)
            heapq.heapify(self._heap)
        else:
            for item in items:
                heapq.heappush(self._heap, item)

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[1]

    def peek(self) -> Event:
        return self._heap[0][1]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
