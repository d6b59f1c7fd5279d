"""Parameter-service walkthrough on the PyTorch port: dispatch/submit,
churn, checkpoint, kill + restore — end to end, as
examples/param_service.py runs it on the JAX package.

Clients call `dispatch` to get a ticket (PPO-assigned model size +
intensity + the current globals) and `submit` to hand back a trained
update, which is codec-decoded against the ticket's reference and streamed
into the globals with staleness-discounted weights. Clients that vanish
mid-round are expired by deadline and their slots freed;
`checkpoint`/`restore` round-trips the *entire* mutable state (the
server's generator included), so the second half of a run replayed after a
kill is bit-identical to never having stopped — this script demonstrates
exactly that, then prints the churn ledger.

  PYTHONPATH=src python examples/param_service_torch.py            # on a card
  PYTHONPATH=src python examples/param_service_torch.py --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.comm import make_codec
from repro_torch.core.latency import AvailabilityModel
from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
from repro_torch.service import (LoadGenerator, ParamService, poisson_trace,
                                 synth_update)
from repro_torch.utils.pytree import tree_leaves

N_CLIENTS, N_EVENTS, RATE_HZ = 8, 160, 1.0


def build_service(device, seed=0):
    cfg = FLSimConfig(dataset="mnist", n_train=300, n_test=80,
                      n_clients=N_CLIENTS, k_per_round=4,
                      batches_per_epoch=1, default_epochs=4,
                      batch_size=16, seed=seed)
    env = FLEnvironment(cfg)
    server = HAPFLServer(env, seed=seed,
                         codec=make_codec("topk+int8", ratio=0.25,
                                          dense_min=64),
                         device=device)
    churn = AvailabilityModel(N_CLIENTS, mean_on=40.0, mean_off=12.0, seed=1)
    return ParamService(server, policy="async", availability=churn,
                        max_inflight=4, min_deadline=10.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the globals and PPO agents live (cuda or "
                         "cpu)")
    args = ap.parse_args()
    trace = poisson_trace(N_EVENTS, N_CLIENTS, RATE_HZ, seed=3)

    # --- manual tour of the API on the first few ticks ----------------- #
    svc = build_service(args.device)
    print(f"device: {svc.server.device}")
    tickets = svc.dispatch([0, 1, 2], now=0.0)
    for tk in tickets:
        print(f"ticket: client={tk.client} size={tk.size} "
              f"intensity={tk.intensity} deadline={tk.deadline:.1f}s")
    receipt = svc.submit(tickets[0].client,
                         synth_update(tickets[0], seed=5), now=1.0)
    print(f"submit: accepted={receipt.accepted} "
          f"staleness={receipt.staleness} "
          f"wire_bytes={receipt.wire_bytes:.0f} "
          f"aggregated={receipt.aggregated}")

    # --- uninterrupted reference run ----------------------------------- #
    ref = build_service(args.device)
    LoadGenerator(ref, trace, seed=5).replay()

    # --- same trace, killed at event 70 and restored -------------------- #
    first = build_service(args.device)
    LoadGenerator(first, trace, seed=5).replay(stop=70)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = first.checkpoint(str(Path(tmp) / "demo"))
        print(f"\ncheckpointed at version {first.version} -> {ckpt}")
        del first                              # the "kill"
        second = build_service(args.device)
        second.restore(ckpt)
    snap = LoadGenerator(second, trace, seed=5).replay(start=70)

    same = all(torch.equal(x, y) for x, y in zip(*(
        tree_leaves([s.server.global_by_size, s.server.lite_params])
        for s in (ref, second))))
    print(f"restored run final params bit-identical to uninterrupted: "
          f"{same}")
    assert same and ref.records == second.records

    # --- churn + observability ledger ---------------------------------- #
    c = snap["counts"]
    print(f"\nledger: dispatched={c['dispatch']} submitted={c['submit']} "
          f"aggregated={c['aggregate']} expired={c.get('expired', 0)} "
          f"rejoined={c.get('rejoin', 0)} "
          f"rejected_busy={c.get('reject_dispatch_busy', 0)}")
    print(f"staleness histogram: {snap['staleness_hist']}")
    print(f"uplink: {snap['up_bytes'] / 1e6:.2f} MB compressed "
          f"(topk+int8 + EF), downlink {snap['down_bytes'] / 1e6:.2f} MB")
    acc = second.evaluate()
    print("final accuracy (synthetic noise updates -> stays at chance; "
          "plug in real client training for learning):",
          {k: round(v, 3) for k, v in acc.items()})


if __name__ == "__main__":
    main()
