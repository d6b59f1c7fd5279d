"""Quickstart on the PyTorch port: the full HAPFL loop on a small simulated
FL fleet, as examples/quickstart.py runs it on the JAX package.

  1. builds a 10-client heterogeneous environment (synthetic MNIST-like data,
     Dirichlet non-IID, 10x speed disparity),
  2. warms the two PPO agents on the latency model,
  3. runs federated rounds with real mutual-KD CNN training (on a card, each
     step's loss and logit gradients come from the kd_loss_grad kernel),
  4. prints straggling latency + accuracy progress.

  PYTHONPATH=src python examples/quickstart_torch.py            # on a card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where params and training live (cuda or cpu)")
    ap.add_argument("--warmup", type=int, default=800,
                    help="latency-only PPO warmup rounds")
    ap.add_argument("--rounds", type=int, default=8,
                    help="federated training rounds")
    args = ap.parse_args()
    cfg = FLSimConfig(dataset="mnist", n_train=1500, n_test=300,
                      default_epochs=8, batches_per_epoch=2, lr=1e-2)
    env = FLEnvironment(cfg)
    print(f"clients: {cfg.n_clients}, per-round: {cfg.k_per_round}, "
          f"speeds: {[round(p.base_speed, 1) for p in env.profiles]}")
    srv = HAPFLServer(env, seed=0, device=args.device)
    print(f"device: {srv.device}, training engine: {srv.engine}")

    print(f"\n== RL warmup (latency-only, {args.warmup} rounds) ==")
    hist = srv.pretrain_rl(args.warmup)
    n = max(len(hist) // 8, 1)
    early = np.mean([h["straggling"] for h in hist[:n]])
    late = np.mean([h["straggling"] for h in hist[-n:]])
    print(f"straggling latency: {early:.1f} -> {late:.1f} "
          f"({100 * (1 - late / early):.1f}% reduction)")

    print(f"\n== federated training ({args.rounds} rounds, real mutual-KD "
          f"training) ==")
    srv.run(args.rounds, verbose=True)
    s = srv.summary()
    print("\nsummary:", {k: round(v, 4) for k, v in s.items()})


if __name__ == "__main__":
    main()
