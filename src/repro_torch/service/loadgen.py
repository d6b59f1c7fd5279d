"""Load generation for the parameter service: Poisson client-arrival
traces and deterministic synthetic updates.

The trace is a flat, pre-materialized list of (time, client) events —
pure in the seed, so a run can be replayed, split, or resumed at any
index (the checkpoint-parity tests replay `trace[:j]`, restore, then
`trace[j:]` and demand bit-identical state vs the uninterrupted replay).

Replay semantics per event — the client "shows up" at `t`:

  * holds a live ticket  -> its training is done: synthesize the update
                            (reference + counter-pure noise) and submit
  * no ticket            -> request a dispatch (the service applies its
                            own admission: capacity, availability)
  * offline per the availability model -> does nothing; if it holds a
    ticket, the deadline poll will eventually expire it (churn)

Synthetic updates are pure in (seed, client, dispatch version, wave), so
the same ticket always produces the same bytes — no wall-clock or call-
order dependence anywhere in the generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.codec import _host
from repro_torch.utils.pytree import (tree_flatten_sorted,
                                      tree_unflatten_sorted)


@dataclass(frozen=True)
class TraceEvent:
    t: float
    client: int


def poisson_trace(n_events: int, n_clients: int, rate_hz: float,
                  seed: int = 0) -> List[TraceEvent]:
    """A global Poisson arrival process at `rate_hz`, each arrival drawn
    uniformly over the client population."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x10AD9E4]))
    gaps = rng.exponential(1.0 / rate_hz, size=n_events)
    times = np.cumsum(gaps)
    clients = rng.integers(0, n_clients, size=n_events)
    return [TraceEvent(float(t), int(c)) for t, c in zip(times, clients)]


def synth_update(ticket, scale: float = 1e-3, seed: int = 0) -> Dict:
    """A deterministic stand-in for client training: the ticket's
    reference params plus small Gaussian noise, pure in (seed, client,
    version, wave). Keeps load benchmarks measuring the *service* ingest
    path rather than CNN training throughput.

    The noise is the reference's numpy stream, drawn leaf by leaf in
    jax.tree_util's order and added to float32 host copies of the
    reference, so from equal references it is bitwise the reference's
    update. The result is float32 tensors on the reference's device."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, ticket.client, ticket.version, ticket.wave, 0x5E9D]))
    out = {}
    for kind, ref in (("local", ticket.ref_local), ("lite", ticket.ref_lite)):
        leaves, treedef = tree_flatten_sorted(ref)
        noisy = [h + scale * rng.standard_normal(h.shape).astype(np.float32)
                 for h in _host(leaves)]
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in noisy]))
        flat = flat.to(leaves[0].device)
        out[kind] = tree_unflatten_sorted(treedef, [
            piece.view(a.shape)
            for piece, a in zip(flat.split([a.size for a in noisy]), noisy)])
    return out


class LoadGenerator:
    """Replays a trace against a ParamService (see module docstring)."""

    def __init__(self, service, trace: Sequence[TraceEvent],
                 update_scale: float = 1e-3, seed: int = 0):
        self.service = service
        self.trace = list(trace)
        self.update_scale = update_scale
        self.seed = seed

    def replay(self, start: int = 0, stop: Optional[int] = None) -> Dict:
        """Drive trace[start:stop]; returns the service metrics snapshot.
        All generator decisions derive from the trace + service state, so
        a replay resumed at `start` after a checkpoint restore continues
        exactly where the interrupted one left off."""
        svc = self.service
        av = svc.availability
        for ev in self.trace[start:stop]:
            svc.poll(ev.t)
            if av is not None and not av.available(ev.client, ev.t):
                continue               # churned away; deadline poll cleans up
            ticket = svc.tickets.get(ev.client)
            if ticket is not None:
                svc.submit(ev.client,
                           synth_update(ticket, self.update_scale, self.seed),
                           now=ev.t)
            else:
                svc.dispatch(ev.client, now=ev.t)
        return svc.metrics.snapshot()
