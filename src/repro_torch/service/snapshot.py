"""Checkpoint/restore of the full parameter-service state (DESIGN.md §14).

One checkpoint is three files sharing a path prefix:

  <path>.npz       every array leaf, flat-keyed (repro_torch.checkpoint)
  <path>.json      ckpt leaf dtype metadata (bf16 view bookkeeping)
  <path>.aux.json  everything that is not an array: counters, rng bit
                   state, PPO buffer/ticket/wave structure, records

The array side reuses `save_checkpoint` on one nested tree; variable-
shaped collections (PPO experience buffers, EF residual lists, open
tickets, the pending aggregation buffer) are packed as string-indexed
dicts whose structure is recorded in the aux file, and restored through
`load_checkpoint_flat` — no `like` skeleton needed for them, while the
fixed-structure parts (model params, optimizer state) rebuild against the
freshly constructed service's live trees, on their devices.

Restore is bit-exact: float scalars ride the aux json (Python's json
round-trips float64 exactly), arrays ride the npz untouched, the numpy
Generator that drives client selection is restored via its bit-generator
state, and the server's `torch.Generator` (PPO actions) via
`get_state`/`set_state`. A restored service continues byte-for-byte as if
it had never stopped (tests/test_torch_service.py pins this end to end on
the CPU, chip_smoke.py on the card).

The files have the reference's layout and `FORMAT`, but a service
snapshot does not cross packages: the reference carries a JAX PRNG key
where this one carries the generator's state, and a generator's state is
particular to its device. `restore_service` refuses a snapshot written by
the other package or for another device type with a ValueError before it
touches the service. (Parameter trees written by
`repro_torch.checkpoint.save_checkpoint` do cross.)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import (_flatten, _rebuild,
                                         load_checkpoint_flat,
                                         save_checkpoint)
from repro_torch.fl.server import WavePlan

FORMAT = 1

#: aux["config"]["package"] of a snapshot written by this package (the
#: reference's snapshots have no such key)
PACKAGE = "repro_torch"


# --------------------------------------------------------------------- #
# packing
# --------------------------------------------------------------------- #
def _pack_agent_owner(owner) -> Tuple[Dict, Dict]:
    """Arrays + aux for a ModelAllocator/IntensityAllocator: agent params,
    optimizer state, the experience buffer, and the pending transition
    (stored by allocate/assign, consumed by feedback — a checkpoint taken
    between the two must carry it)."""
    agent = owner.agent
    tree = {"params": agent.params, "opt": agent.opt_state,
            "buffer": {str(j): dict(b) for j, b in enumerate(agent.buffer)}}
    pending = getattr(owner, "_pending", None) or {}
    if pending:
        tree["pending"] = {"state": pending["state"],
                           "action": pending["action"]}
    aux = {"buffer_len": len(agent.buffer),
           "has_pending": bool(pending),
           "pending_logprob": (float(pending["logprob"]) if pending
                               else None),
           "reward_history": [float(r) for r in agent.reward_history]}
    return tree, aux


def _ef_key(key) -> str:
    client, kind, size = key
    return f"{client}|{kind}|{size}"


def _config(svc) -> Dict:
    srv = svc.server
    return {"package": PACKAGE,
            "device": srv.device.type,
            "policy": svc.policy.name,
            "codec": srv.codec.name if srv.codec is not None else None,
            "aggregation": srv.aggregation,
            "k_per_round": srv.env.cfg.k_per_round,
            "n_clients": srv.env.cfg.n_clients,
            "sizes": sorted(srv.env.pool)}


def _pack(svc) -> Tuple[Dict, Dict]:
    srv = svc.server
    t1, a1 = _pack_agent_owner(srv.allocator)
    t2, a2 = _pack_agent_owner(srv.intensity)
    tree = {
        "server": {"gen": srv.gen.get_state(), "lite": srv.lite_params,
                   "globals": srv.global_by_size},
        "ppo1": t1, "ppo2": t2,
        "ef": {_ef_key(k): {str(i): leaf for i, leaf in enumerate(state)}
               for k, state in srv._ef.items()},
        "tickets": {str(tk.client): {"ref_local": tk.ref_local,
                                     "ref_lite": tk.ref_lite}
                    for tk in svc.tickets.values()},
        "buffer": {str(j): e["params"] for j, e in enumerate(svc.buffer)},
    }
    aux = {
        "format": FORMAT,
        "config": _config(svc),
        "version": svc.version,
        "round": srv._round,
        "wave_count": svc._wave_count,
        "records": svc.records,
        "metrics": svc.metrics.pack(),
        "env_rng": srv.env.rng.bit_generator.state,
        "ppo1": a1, "ppo2": a2,
        "ef": [[int(c), kind, size, len(state)]
               for (c, kind, size), state in srv._ef.items()],
        "buffer": [{k: e[k] for k in ("client", "size", "entropy",
                                      "acc_local", "acc_lite", "version")}
                   for e in svc.buffer],
        "tickets": [{"client": tk.client, "wave": tk.wave,
                     "index": tk.index, "size": tk.size,
                     "intensity": tk.intensity, "round_idx": tk.round_idx,
                     "version": tk.version, "t_dispatch": tk.t_dispatch,
                     "deadline": tk.deadline, "expected": tk.expected}
                    for tk in svc.tickets.values()],
        "waves": {str(w): {
            "round_idx": info["plan"].round_idx,
            "clients": info["plan"].clients,
            "assess": info["plan"].assess,
            "sizes": info["plan"].sizes,
            "intensities": [int(i) for i in info["plan"].intensities],
            "local_times": info["plan"].local_times,
            "version": info["plan"].version,
            "t_dispatch": info["plan"].t_dispatch,
            "outstanding": sorted(info["outstanding"]),
        } for w, info in svc._waves.items()},
        "expired_once": svc._churned_clients(),
    }
    return tree, aux


def save_service(svc, path) -> None:
    tree, aux = _pack(svc)
    save_checkpoint(path, tree, step=svc.version)
    Path(str(path) + ".aux.json").write_text(json.dumps(aux))


# --------------------------------------------------------------------- #
# restoring
# --------------------------------------------------------------------- #
def _restore_tree(like, flat: Dict, prefix: str):
    """Rebuild a tree with `like`'s structure from flat-keyed leaves, each
    onto the device of the live leaf it replaces."""
    live = _flatten(like)

    def leaf(k):
        return flat[f"{prefix}/{k}" if k else prefix].to(live[k].device)
    try:
        return _rebuild(like, leaf)
    except KeyError as e:
        raise KeyError(f"checkpoint is missing leaf {e.args[0]!r} under "
                       f"{prefix!r} — was it saved with a different "
                       f"model pool or agent config?") from None


def _restore_agent_owner(owner, flat: Dict, aux: Dict, prefix: str) -> None:
    agent = owner.agent
    agent.params = _restore_tree(agent.params, flat, f"{prefix}/params")
    agent.opt_state = _restore_tree(agent.opt_state, flat, f"{prefix}/opt")
    def entry(j):
        at = f"{prefix}/buffer/{j}"
        return {"state": flat[f"{at}/state"].numpy(),
                "action": flat[f"{at}/action"].numpy(),
                "logprob": np.float32(flat[f"{at}/logprob"].item()),
                "reward": np.float32(flat[f"{at}/reward"].item())}
    agent.buffer = [entry(j) for j in range(aux["buffer_len"])]
    agent.reward_history = [float(r) for r in aux["reward_history"]]
    if aux["has_pending"]:
        owner._pending = {
            "state": flat[f"{prefix}/pending/state"].numpy(),
            "action": flat[f"{prefix}/pending/action"].numpy(),
            "logprob": float(aux["pending_logprob"])}
    else:
        owner._pending = {}


def _check_config(svc, cfg: Dict, path) -> None:
    live = _config(svc)
    if cfg.get("package") != PACKAGE:
        raise ValueError(
            f"checkpoint {path!s} is a service snapshot of another package "
            f"({cfg.get('package') or 'repro, the JAX reference'}), which "
            f"carries its own random state: service snapshots do not cross "
            f"packages (parameter checkpoints do)")
    bad = [f"{k}: checkpoint={cfg.get(k)!r} vs service={live[k]!r}"
           for k in live if cfg.get(k) != live[k]]
    if bad:
        raise ValueError(f"checkpoint {path!s} was written by a differently "
                         "configured service — " + "; ".join(bad))


def restore_service(svc, path) -> None:
    aux = json.loads(Path(str(path) + ".aux.json").read_text())
    if aux.get("format") != FORMAT:
        raise ValueError(f"unsupported service checkpoint format "
                         f"{aux.get('format')!r} (want {FORMAT})")
    _check_config(svc, aux["config"], path)
    # host first: the numpy-side state (buffers, EF residuals) stays on
    # the host, and each live tree's leaves go back to their own device
    flat, _ = load_checkpoint_flat(path, device="cpu")
    srv = svc.server

    srv.gen.set_state(flat["server/gen"])
    srv.lite_params = _restore_tree(srv.lite_params, flat, "server/lite")
    srv.global_by_size = {
        s: _restore_tree(srv.global_by_size[s], flat, f"server/globals/{s}")
        for s in srv.global_by_size}
    _restore_agent_owner(srv.allocator, flat, aux["ppo1"], "ppo1")
    _restore_agent_owner(srv.intensity, flat, aux["ppo2"], "ppo2")
    srv._round = int(aux["round"])
    # in place, not reassignment: srv._ef aliases store.ef (one home for
    # sparse per-client codec state) and restore must not sever that link
    srv._ef.clear()
    srv._ef.update({
        (c, kind, size): [flat[f"ef/{c}|{kind}|{size}/{i}"].numpy()
                          for i in range(n)]
        for c, kind, size, n in aux["ef"]})
    srv.env.rng.bit_generator.state = aux["env_rng"]

    svc.version = int(aux["version"])
    svc._wave_count = int(aux["wave_count"])
    svc.records = list(aux["records"])
    svc.metrics.unpack(aux["metrics"])
    svc._expired_once = set(aux["expired_once"])

    svc._waves = {}
    for w, info in aux["waves"].items():
        plan = WavePlan(
            round_idx=int(info["round_idx"]), clients=list(info["clients"]),
            assess=list(info["assess"]), sizes=list(info["sizes"]),
            intensities=list(info["intensities"]),
            local_times=list(info["local_times"]),
            version=int(info["version"]),
            t_dispatch=float(info["t_dispatch"]))
        m = len(plan.clients)
        plan.client_params = []
        plan.accs_local = [0.0] * m
        plan.accs_lite = [0.0] * m
        svc._waves[int(w)] = {"plan": plan,
                              "outstanding": set(info["outstanding"])}

    from repro_torch.service.service import Ticket
    svc.tickets = {}
    for t in aux["tickets"]:
        c = int(t["client"])
        svc.tickets[c] = Ticket(
            client=c, wave=int(t["wave"]), index=int(t["index"]),
            size=t["size"], intensity=int(t["intensity"]),
            round_idx=int(t["round_idx"]), version=int(t["version"]),
            t_dispatch=float(t["t_dispatch"]),
            deadline=float(t["deadline"]), expected=float(t["expected"]),
            ref_local=_restore_tree(srv.global_by_size[t["size"]], flat,
                                    f"tickets/{c}/ref_local"),
            ref_lite=_restore_tree(srv.lite_params, flat,
                                   f"tickets/{c}/ref_lite"))

    svc.buffer = []
    for j, meta in enumerate(aux["buffer"]):
        params = {
            "local": _restore_tree(srv.global_by_size[meta["size"]], flat,
                                   f"buffer/{j}/local"),
            "lite": _restore_tree(srv.lite_params, flat, f"buffer/{j}/lite")}
        svc.buffer.append({"client": int(meta["client"]),
                           "size": meta["size"], "params": params,
                           "entropy": float(meta["entropy"]),
                           "acc_local": float(meta["acc_local"]),
                           "acc_lite": float(meta["acc_lite"]),
                           "version": int(meta["version"])})

    # rebuild the ClientStore's live slots from the restored tickets so
    # vectorized expiry / churn checks continue bit-identically (history
    # counters are observability-only and restart at zero)
    store = getattr(svc, "store", None)
    if store is not None:
        store.reset_slots()
        for c, tk in svc.tickets.items():
            store.open_slots([c], tk.wave, [tk.index], tk.version,
                             tk.deadline)
        for c in aux["expired_once"]:
            store.churned[int(c)] = True


def latest_checkpoint(ckpt_dir) -> Optional[str]:
    """Newest `ckpt-*` path prefix in a directory, or None."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    auxes: List[Path] = sorted(d.glob("ckpt-*.aux.json"))
    if not auxes:
        return None
    name = auxes[-1].name[:-len(".aux.json")]
    return str(d / name)
