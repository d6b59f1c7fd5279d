"""Launch a long-running HAPFL parameter service and drive it with a
Poisson client-arrival trace (repro_torch.service; DESIGN.md §14).

Counterpart of ``repro.launch.serve``, with its flags, and --device (CUDA
unless given). Example (CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --n-clients 16 \
      --events 400 --policy async --codec topk+int8 \
      --checkpoint-dir /tmp/hapfl-ckpt --device cpu

If --checkpoint-dir already holds a checkpoint, the service resumes from
the newest one instead of starting cold (kill the process mid-run and
relaunch with the same flags to watch it continue where it left off).
The metrics snapshot + structured event log land in --metrics-out.
"""
from __future__ import annotations

import argparse

from repro_torch.comm import make_codec
from repro_torch.core.latency import AvailabilityModel
from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
from repro_torch.service import (LoadGenerator, ParamService,
                                 latest_checkpoint, poisson_trace)


def build_service(n_clients: int, k_per_round: int, policy: str,
                  codec: str, seed: int, min_deadline: float,
                  checkpoint_dir=None, checkpoint_every=None,
                  churn: bool = True, horizon: float = 100.0,
                  health=None, slos=None, device=None):
    """The service `main` drives: an mnist HAPFL server on `device` (CUDA
    when None) behind a ParamService, with on/off churn unless `churn` is
    False."""
    cfg = FLSimConfig(dataset="mnist", n_clients=n_clients,
                      k_per_round=k_per_round, n_train=16 * n_clients,
                      n_test=128, batches_per_epoch=1, default_epochs=8,
                      batch_size=16, seed=seed)
    env = FLEnvironment(cfg)
    c = None if codec in ("identity", "none") else make_codec(
        codec, ratio=0.08, dense_min=256)
    srv = HAPFLServer(env, seed=seed, codec=c, device=device)
    av = AvailabilityModel(n_clients, mean_on=horizon / 4.0,
                           mean_off=horizon / 10.0,
                           seed=seed) if churn else None
    return ParamService(srv, policy=policy, availability=av,
                        max_inflight=k_per_round,
                        min_deadline=min_deadline,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        health=health, slos=slos)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-clients", type=int, default=16)
    ap.add_argument("--k-per-round", type=int, default=4)
    ap.add_argument("--policy", default="async",
                    choices=("async", "buffered"))
    ap.add_argument("--codec", default="identity",
                    help="identity | topk | int8 | topk+int8 | ...")
    ap.add_argument("--events", type=int, default=400)
    ap.add_argument("--rate-hz", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-churn", action="store_true",
                    help="disable the on/off availability model")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20,
                    help="checkpoint every N aggregations (needs "
                         "--checkpoint-dir)")
    ap.add_argument("--metrics-out", default="artifacts/serve_metrics.json")
    ap.add_argument("--eval", action="store_true",
                    help="report global test accuracy when the trace ends")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a dual-clock span trace of the run and "
                         "write Chrome trace-event JSON (open it at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--health-report", default=None, metavar="OUT.md",
                    help="attach a FleetHealth tracker + the default "
                         "service SLOs and write the fleet health report "
                         "(markdown + .json sibling) when the trace ends")
    ap.add_argument("--prom-out", default=None, metavar="OUT.prom",
                    help="write a Prometheus text-exposition snapshot of "
                         "the service metrics registry when the trace ends")
    ap.add_argument("--events-jsonl", default=None, metavar="OUT.jsonl",
                    help="tee the structured event log into an append-only "
                         "JSONL stream with rotation")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.enable()

    slos = None
    if args.health_report:
        from repro_torch.obs.slo import default_service_slos
        slos = default_service_slos()

    horizon = args.events / args.rate_hz
    svc = build_service(
        args.n_clients, args.k_per_round, args.policy, args.codec,
        args.seed, min_deadline=1.5 * args.n_clients / args.rate_hz,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=(args.checkpoint_every
                          if args.checkpoint_dir else None),
        churn=not args.no_churn, horizon=horizon,
        health=bool(args.health_report) or None, slos=slos,
        device=args.device)

    jsonl = None
    if args.events_jsonl:
        from repro_torch.obs.export import JsonlEventLog
        jsonl = JsonlEventLog(args.events_jsonl)
        svc.metrics.attach_jsonl(jsonl)

    resume = (latest_checkpoint(args.checkpoint_dir)
              if args.checkpoint_dir else None)
    if resume:
        svc.restore(resume)
        print(f"resumed from {resume} at version {svc.version}")

    trace = poisson_trace(args.events, args.n_clients, args.rate_hz,
                          seed=args.seed)
    snap = LoadGenerator(svc, trace, seed=args.seed).replay()

    c = snap["counts"]
    print(f"policy={args.policy} codec={args.codec} "
          f"version={svc.version} waves={svc._wave_count}")
    print(f"dispatched={c.get('dispatch', 0)} submitted={c.get('submit', 0)} "
          f"aggregated={c.get('aggregate', 0)} expired={c.get('expired', 0)} "
          f"rejoined={c.get('rejoin', 0)}")
    print(f"updates/sec={snap['updates_per_sec']} "
          f"dispatch={snap['dispatch']} staleness={snap['staleness_hist']}")
    if args.checkpoint_dir:
        path = svc.checkpoint()
        print(f"final checkpoint: {path}")
    if args.eval:
        print("accuracy:", {k: round(v, 4)
                            for k, v in svc.evaluate().items()})
    svc.metrics.dump(args.metrics_out)
    print(f"metrics + event log -> {args.metrics_out}")
    if args.health_report:
        from repro_torch.obs.report import write_health_report
        md_path, json_path = write_health_report(
            args.health_report,
            [{"label": f"service run ({args.policy}, codec={args.codec}, "
                       f"{args.events} events)",
              "health": svc.health, "slo": svc.slos, "store": svc.store,
              "meta": {"n_clients": args.n_clients,
                       "k_per_round": args.k_per_round,
                       "policy": args.policy, "codec": args.codec,
                       "events": args.events, "seed": args.seed}}])
        print(f"fleet health report -> {md_path} (+ {json_path})")
    if args.prom_out:
        from repro_torch.obs.export import write_prometheus
        print(f"prometheus exposition -> "
              f"{write_prometheus(svc.metrics.registry, args.prom_out)}")
    if jsonl is not None:
        jsonl.close()
        print(f"event stream ({jsonl.n_written} events, "
              f"{jsonl.n_rotations} rotations) -> {jsonl.path}")
    if tracer is not None:
        tracer.export(args.trace)
        print(f"trace ({len(tracer.events)} events) -> {args.trace} "
              f"(load at https://ui.perfetto.dev)")
    return svc


if __name__ == "__main__":
    main()
