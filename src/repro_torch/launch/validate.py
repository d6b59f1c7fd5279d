"""Static (no-trace) validation of every (arch x shape) combination:
dimension divisibility on the "model" axis, cache sizing, an analytic
per-card HBM estimate of the training step, decode-path applicability.
Runs in a second: the cheap pre-flight before `launch.dryrun`.

Counterpart of ``repro.launch.validate``, with its arithmetic as it is
(the hard-coded ``/ 16`` terms of `analytic_hbm_train` included), so that
both give the same numbers. `check` keeps the reference's default model
axis of 16; `main` checks at ``--model-axis``, by default the port's
production "model" axis, one NVLink node of `launch.mesh.NODE_CARDS` (8)
cards.

  PYTHONPATH=src python -m repro_torch.launch.validate [--model-axis 8]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import NODE_CARDS


def analytic_hbm_train(cfg, lite, shape, n_chips, microbatch=4) -> float:
    """Rough per-chip bytes for the joint KD train step (weights + opt +
    activations at microbatch granularity)."""
    n = cfg.num_params() + lite.num_params()
    weights = 2 * n / n_chips
    opt = 12 * n / n_chips            # fp32 m, v, master-ish
    grads = 4 * n / n_chips
    per_chip_tokens = shape.global_batch * shape.seq_len / max(n_chips // 16, 1) \
        / 16 / max(microbatch, 1)
    acts = per_chip_tokens * cfg.d_model * 2 * 4  # ~4 live tensors, bf16
    logits = per_chip_tokens * cfg.vocab_size / 16 * 4 * 2
    return weights + opt + grads + acts + logits


def check(arch: str, shape_name: str, model_axis=16) -> list:
    issues = []
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        cfg = cfg.long_ctx_variant()
        issues.append(("info", "runs as -swa variant (faithful config skips)"))
    hd = cfg.resolved_head_dim
    if (cfg.n_heads * hd) % model_axis:
        issues.append(("warn", f"q-dim {cfg.n_heads * hd} not divisible by model axis"))
    if cfg.d_ff and cfg.d_ff % model_axis:
        issues.append(("warn", f"d_ff {cfg.d_ff} not divisible"))
    if cfg.vocab_size % model_axis:
        issues.append(("info", f"vocab {cfg.vocab_size} uneven -> head kept "
                               f"replicated on model axis"))
    if cfg.is_moe and cfg.n_experts % model_axis:
        issues.append(("info", f"{cfg.n_experts} experts -> tensor-parallel "
                               f"inside experts (ff sharding)"))
    if shape.mode == "decode":
        if cfg.n_kv_heads % model_axis:
            issues.append(("info", "kv_heads uneven -> shard_map flash-decode"))
        if cfg.sliding_window:
            issues.append(("info", f"ring-buffer cache {cfg.sliding_window}"))
    return issues


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--model-axis", type=int, default=NODE_CARDS,
                    help="size of the mesh's 'model' axis (default: the "
                         "cards of one NVLink node)")
    args = ap.parse_args(argv)
    n_warn = 0
    for arch in ARCH_IDS:
        for shape_name in INPUT_SHAPES:
            for sev, msg in check(arch, shape_name, args.model_axis):
                if sev == "warn":
                    n_warn += 1
                print(f"[{sev}] {arch} x {shape_name}: {msg}")
    print(f"\n{n_warn} warnings over "
          f"{len(ARCH_IDS) * len(INPUT_SHAPES)} combos "
          f"(model axis {args.model_axis})")
    if args.strict and n_warn:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
