"""The program's phase spans in a traced run, as the span metrics
(`metrics/*span*`, `host_issue_share.train`, `moe_fwd_ms.train`,
`replay*_ms.serve`) read them.

The program records its phase spans (`repro_torch.obs.trace.phase`) while
a torch.profiler session runs, into a bounded buffer that
`repro_torch.obs.trace.profiled()` returns: each span's name, `seq` (its
entry order), `root` (the seq of the outermost span open around it), host
(start, end) in seconds and device (start, end) in ms from its root's
start, read from CUDA events. The traced run profiles `profile_steps`
steps (or `profile_calls` calls) on the device alone, then one more with
the host traced, which slows the host; only the first are read. Where the
program has no such function, records no device interval (off CUDA) or
gave fewer roots than were profiled, there is nothing to read: None.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def recorded() -> Optional[List[Dict]]:
    """The program's profiled spans, or None where it has none."""
    try:
        from repro_torch.obs.trace import profiled
    except ImportError:
        return None
    return profiled()


def sessions(rec: dict, root: str, count_key: str
             ) -> Optional[List[List[Dict]]]:
    """For each of the first rec[count_key] spans named `root`: [the root,
    then every span under it in entry order]; None where there is nothing
    to read."""
    spans = recorded()
    n = rec.get(count_key)
    if not spans or not n:
        return None
    roots = [s for s in spans if s["name"] == root][:n]
    if len(roots) != n or any(r["device"] is None for r in roots):
        return None
    return [[r] + [s for s in spans if s["root"] == r["seq"]
                   and s["seq"] != r["seq"]] for r in roots]


def named(rec: dict, root: str, count_key: str, name: str,
          each: int) -> Optional[List[List[Dict]]]:
    """For each root of `sessions`, its `each` spans named `name`; None
    where any root has another number of them."""
    got = sessions(rec, root, count_key)
    if got is None:
        return None
    out = [[s for s in spans if s["name"] == name] for spans in got]
    return out if all(len(s) == each for s in out) else None


def device_ms(span: Dict) -> float:
    return span["device"][1] - span["device"][0]


def host_ms(span: Dict) -> float:
    return 1e3 * (span["host"][1] - span["host"][0])


def mean(values: List[float]) -> float:
    return sum(values) / len(values)
