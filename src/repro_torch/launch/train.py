"""Single-host training driver: HAPFL joint-KD training of an assigned arch,
at reduced scale (--smoke) or at full width, on one card (or the CPU).

Counterpart of ``repro.launch.train``, with its flags, and --device
(CUDA unless given). Example (CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 5 --batch 4 --seq 128 --device cpu \
      --checkpoint /tmp/llama-smoke

The step updates its state in place (`train/step.py`), as the reference's
driver donates its state to the jitted step. --checkpoint saves
``state["params"]`` after the last step in the reference's format
(``repro_torch.checkpoint``): either package restores it, a tree of mixed
bf16 and fp32 leaves included (an MoE router, an SSM's gates and
recurrent weights). Every family trains: MoE configs with the router's
aux losses in the loss (`train/step.py`), audio configs on codebook
tokens, VLM configs on random patch embeddings (`token_batches`), and the
SSM (xLSTM, pure Mamba2) and hybrid (zamba2) configs on tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.models.api import dummy_batch
from repro_torch.train.step import (TrainStepConfig, make_hapfl_train_step,
                                    make_train_state)
from repro_torch.utils.device import resolve_device


def token_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0,
                  device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """`steps` batches of consecutive windows of one `make_token_dataset`
    stream (the reference's numpy stream, so the same tokens): {"tokens",
    "labels"} (batch, seq), labels the tokens shifted by one. An audio
    model's are (batch, seq, nq), codebook q the stream rolled by q along
    the sequence, as the reference rolls it. A VLM's batch i is
    `dummy_batch` drawn from a torch generator seeded with i, where the
    reference draws from jax.random.PRNGKey(i): the structure is the
    reference's, the embeddings and labels are not."""
    device = resolve_device(device)
    stream = make_token_dataset(cfg.vocab_size, batch * (seq + 1) * steps + 1,
                                seed)
    n = batch * (seq + 1)
    for i in range(steps):
        if cfg.input_mode == "embeddings":
            yield dummy_batch(cfg, batch, seq,
                              torch.Generator(device).manual_seed(i),
                              device=device)
            continue
        chunk = stream[i * n:(i + 1) * n].reshape(batch, seq + 1)
        if cfg.n_codebooks:
            chunk = np.stack([np.roll(chunk, q, -1)
                              for q in range(cfg.n_codebooks)], -1)
        yield {"tokens": torch.as_tensor(chunk[:, :-1], device=device),
               "labels": torch.as_tensor(chunk[:, 1:], device=device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable ~100M-class)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    lite = cfg.lite()
    if args.smoke:
        lite = dataclasses.replace(lite, dtype=torch.float32, remat=False,
                                   scan_layers=False)
    tcfg = TrainStepConfig(lr=args.lr)
    state = make_train_state(torch.Generator(device).manual_seed(0), cfg,
                             lite, tcfg, device)
    step = make_hapfl_train_step(cfg, lite, tcfg)

    t0 = time.time()
    for i, batch in enumerate(token_batches(cfg, args.batch, args.seq,
                                            args.steps, device=device)):
        state, metrics = step(state, batch)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"ce_local={float(metrics['ce_local']):.4f} "
                  f"ce_lite={float(metrics['ce_lite']):.4f} "
                  f"({time.time() - t0:.1f}s)")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state["params"], step=args.steps)
        print("saved", args.checkpoint)
    return state


if __name__ == "__main__":
    main()
