"""Fleet health report generator (DESIGN.md §16): renders one or more
`FleetHealth` summaries (plus optional `SimResult` and SLO rows) as a
markdown artifact with a JSON sibling — what `--health-report` on
`launch/serve.py` and `benchmarks/run.py` writes, and what the
committed artifacts/bench/fleet_health.{md,json} are.

A *section* is one run's view:

  {"label": "simulated cohort run",       # heading
   "health": <FleetHealth or its summary() dict>,
   "result": <SimResult or None>,         # -> result.summary()
   "slo": <SLOSet or list of rows or None>,
   "store": <ClientStore or None>,        # churn cross-check
   "meta": {...}}                         # free-form config echo

Markdown stays plain pipe tables so the artifact diffs cleanly; the
JSON sibling carries the full summaries for the SLO regression gate
(`benchmarks/check_regression.py`) and ad-hoc analysis.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.health import PHASES

#: RL diagnostic keys surfaced in the trend table (per agent)
_RL_KEYS = ("entropy", "reward", "approx_kl", "clip_fraction", "n_updates")


def _num(v, nd: int = 4) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{round(v, nd):g}"
    return str(v)


def _table(headers: Sequence[str], rows: Sequence[Sequence]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(_num(c) for c in row) + " |" for row in rows]
    return out


def _health_summary(section: Dict) -> Optional[Dict]:
    h = section.get("health")
    if h is None:
        return None
    if isinstance(h, dict):
        return h
    return h.summary(store=section.get("store"))


def _slo_rows(section: Dict) -> Optional[List[Dict]]:
    s = section.get("slo")
    if s is None:
        return None
    return s if isinstance(s, list) else s.report()


def _rl_trend(rl_rows: List[Dict]) -> List[List]:
    """first -> last trend per agent over the recorded wave diagnostics."""
    rows = []
    agents = sorted({k for r in rl_rows for k in r if k != "wave"})
    for agent in agents:
        seen = [r[agent] for r in rl_rows if agent in r]
        if not seen:
            continue
        first, last = seen[0], seen[-1]
        for key in _RL_KEYS:
            a, b = first.get(key), last.get(key)
            if a is None and b is None:
                continue
            rows.append([agent, key, _num(a), _num(b)])
    return rows


def render_section(section: Dict) -> Tuple[List[str], Dict]:
    """One section's markdown lines + JSON payload."""
    label = section.get("label", "run")
    md = [f"## {label}", ""]
    data: Dict = {"label": label}
    if section.get("meta"):
        data["meta"] = dict(section["meta"])
        md += ["```", json.dumps(data["meta"], sort_keys=True), "```", ""]
    result = section.get("result")
    if result is not None:
        data["result"] = result.summary()
        md += _table(["metric", "value"],
                     sorted(data["result"].items())) + [""]

    health = _health_summary(section)
    if health is not None:
        data["health"] = health
        att = health["attribution"]
        md += [f"{health['clients_seen']}/{health['n_clients']} clients "
               f"seen over {health['n_waves']} waves.", ""]
        md += ["### Fleet phase attribution", ""]
        md += _table(["phase", "total_s", "share",
                      "straggler-dominant waves"],
                     [[p, att["total_s"][p], att["share"][p],
                       att["straggler_dominant_waves"][p]]
                      for p in PHASES]) + [""]
        md += ["### Straggler attribution (last "
               f"{len(health['waves'])} waves)", ""]
        md += _table(
            ["wave", "straggler", "size", "turnaround_s",
             "dominant phase"] + [f"{p}_s" for p in PHASES] + ["z"],
            [[r["wave"], r["straggler"], r["size"], r["turnaround_s"],
              f"**{r['dominant_phase']}**"]
             + [r["phases_s"][p] for p in PHASES] + [r["z"]]
             for r in health["waves"]]) + [""]
        if health["stragglers"]:
            md += ["### Top stragglers (by waves as slowest client)", ""]
            md += _table(
                ["client", "waves", "straggler waves", "dominant phase",
                 "ewma_s", "last z", "slow anomalies"],
                [[r["client"], r["waves"], r["straggler_waves"],
                  r["dominant_phase"], r["ewma_s"], r["last_z"],
                  r["slow_anomalies"]] for r in health["stragglers"]]) + [""]
        groups = {s: g for s, g in health["groups"].items() if g}
        if groups:
            md += ["### Per-size-group turnaround", ""]
            md += _table(["size", "n", "p50_s", "p99_s", "mean_s", "max_s"],
                         [[s, g["n"], g["p50_s"], g["p99_s"], g["mean_s"],
                           g["max_s"]] for s, g in sorted(groups.items())])
            md += [""]
        drift = health["drift"]
        md += ["### Drift / anomalies", "",
               f"{drift['clients_flagged_slow']} client(s) flagged slow, "
               f"{drift['clients_flagged_fast']} fast "
               f"(|z| > {drift['z_thresh']:g} vs own EWMA baseline).", ""]
        if drift["top_drifting"]:
            md += _table(["client", "slow anomalies", "ewma_s",
                          "last turnaround_s", "last z"],
                         [[r["client"], r["slow_anomalies"], r["ewma_s"],
                           r["last_turnaround_s"], r["last_z"]]
                          for r in drift["top_drifting"]]) + [""]
        churn = health["churn"]
        md += ["### Churn / outcomes", ""]
        md += _table(["outcome", "count", "per wave"],
                     [[k, churn["outcomes"][k], churn["per_wave"][k]]
                      for k in sorted(churn["outcomes"])]) + [""]
        if "store" in churn:
            md += _table(["store counter", "value"],
                         sorted(churn["store"].items())) + [""]
        if health["rl"]:
            md += ["### RL diagnostics trend (first -> last wave)", ""]
            md += _table(["agent", "metric", "first", "last"],
                         _rl_trend(health["rl"])) + [""]

    slo_rows = _slo_rows(section)
    if slo_rows is not None:
        data["slo"] = slo_rows
        md += ["### SLOs", ""]
        md += _table(["slo", "value", "threshold", "status", "burn rate",
                      "checks", "breaches"],
                     [[r["name"], r.get("value"), r.get("threshold"),
                       r["status"], r.get("burn_rate"), r.get("checks", 0),
                       r.get("breaches", 0)] for r in slo_rows]) + [""]
    return md, data


def fleet_health_report(sections: Sequence[Dict],
                        title: str = "HAPFL fleet health report",
                        ) -> Tuple[str, Dict]:
    """Render all sections; returns (markdown, json payload)."""
    md = [f"# {title}", ""]
    data = {"title": title, "sections": []}
    for section in sections:
        smd, sdata = render_section(section)
        md += smd
        data["sections"].append(sdata)
    return "\n".join(md).rstrip() + "\n", data


def write_health_report(path_md, sections: Sequence[Dict],
                        title: str = "HAPFL fleet health report",
                        ) -> Tuple[Path, Path]:
    """Write the markdown report and its JSON sibling (same stem,
    `.json`); returns both paths."""
    path_md = Path(path_md)
    path_md.parent.mkdir(parents=True, exist_ok=True)
    md, data = fleet_health_report(sections, title=title)
    path_md.write_text(md)
    path_json = path_md.with_suffix(".json")
    path_json.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    return path_md, path_json
