#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch and CUDA versions.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc with nvcc (one process per
                source, all at once) and print ptxas' register/spill report.
  3. kernels  — hold kd_loss_fwd / kd_loss_bwd against their plain PyTorch
                versions at the main path's row counts (4 and 8 padded
                clients x batch 32), a ragged N, a ragged V and a vocabulary
                shape in fp32 and bf16 (tolerances of
                tests/test_kernels.py: fp32 1e-4, bf16 5e-2).
  4. main path— HAPFL Algorithm 1 on the paper's cifar10 pool at full width
                (small + large CNNs, 10 clients, 6 per round): 10
                latency-only PPO pretraining rounds, then 3 training rounds
                through the batched engine. Launch counters are zeroed just
                before and read just after; each kernel must have launched
                exactly once per padded step of every size group. A shape
                the main path gave the kernels that phase 3 did not check is
                checked now.
  5. timing   — each kernel and its plain version at every shape the main
                path gave it and at the vocabulary shape. `ms` is device
                time: the calls are captured into one CUDA graph and its
                replay is timed with CUDA events, so the host's issue cost
                is left out. `eager_ms` is the wall time per call of
                back-to-back eager calls, the wrapper's host cost included.
  6. parity   — with PPO off and the same starting globals, one ragged
                cohort trained on the card (through the kernels) equals the
                same cohort trained on the CPU (plain versions).
  7. profile  — one more training round under torch.profiler: device time
                by kernel and the device's busy share of the round.

The parity phases (3 and 6) turn TF32 off for cuDNN and matmuls, so that
both sides compute in full float32, and restore the defaults afterwards.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without CUDA, or run outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the main path calls kd_loss on C*B logit rows: C is a size group's client
# count padded to a power of two, at least 4; 6 clients per round give
# groups of 4 or 8 padded clients, at batch 32
CHECK_SHAPES = [(128, 10, "float32"), (256, 10, "float32"),
                (1000, 10, "float32"), (64, 777, "float32"),
                (2048, 32000, "float32"), (2048, 32000, "bfloat16")]
VOCAB_SHAPES = [(2048, 32000, "float32"), (2048, 32000, "bfloat16")]


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def full_fp32(torch):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------- #
# 1-2. device and build
# ---------------------------------------------------------------------- #
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s in all, per source "
        f"{ {k: round(v, 2) for k, v in per_source.items()} }")
    for name, report in _build.reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------- #
# 3 and 5. kernels against their plain versions, and their times
# ---------------------------------------------------------------------- #
def _inputs(torch, N, V, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn((N, V), generator=g, device="cuda") * 3).to(dt)
    y = (torch.randn((N, V), generator=g, device="cuda") * 3).to(dt)
    lab = torch.randint(0, V, (N,), generator=g, device="cuda",
                        dtype=torch.int32)
    grads = torch.randn((4, N), generator=g, device="cuda")
    return x, y, lab, grads


def _stopgrad_grads(torch, ref, x, y, lab, grads):
    """dx, dy by autograd of the plain forward, with the Eqs. 33-34
    stop-gradients: (ce_x, kl_xy) see y detached, (ce_y, kl_yx) x."""
    x = x.detach().requires_grad_(True)
    y = y.detach().requires_grad_(True)
    tx = ref.kd_loss_ref(x, y.detach(), lab)
    ty = ref.kd_loss_ref(x.detach(), y, lab)
    terms = (tx["ce_x"], ty["ce_y"], tx["kl_xy"], ty["kl_yx"])
    loss = sum((g * t).sum() for g, t in zip(grads, terms))
    return torch.autograd.grad(loss, (x, y))


def _max_err(torch, got, exp):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, exp))


def _close(torch, got, exp, tol, what):
    for a, b in zip(got, exp):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{what}: {m}")


def phase_kernels(torch, shapes):
    """{(N, V, dtype): (fwd max|err|, bwd max|err|)} at each shape."""
    from repro_torch.kernels import kd_loss as kd, ref
    errs = {}
    with full_fp32(torch):
        for N, V, dtype in shapes:
            x, y, lab, grads = _inputs(torch, N, V, dtype, seed=N + V)
            terms, stats = kd.kd_loss_fwd(x, y, lab)
            dx, dy = kd.kd_loss_bwd(x, y, lab, stats, grads)
            torch.cuda.synchronize()
            exp_terms, exp_stats = ref.kd_loss_fwd_ref(x, y, lab)
            exp_dx, exp_dy = _stopgrad_grads(torch, ref, x, y, lab, grads)
            tol = TOL[dtype]
            _close(torch, (terms, stats), (exp_terms, exp_stats), tol,
                   f"kd_loss_fwd {N}x{V} {dtype}")
            _close(torch, (dx, dy), (exp_dx, exp_dy), tol,
                   f"kd_loss_bwd {N}x{V} {dtype}")
            # the autograd.Function drives the same pair of kernels
            xa = x.detach().requires_grad_(True)
            ya = y.detach().requires_grad_(True)
            out = kd.kd_loss(xa, ya, lab)
            fdx, fdy = torch.autograd.grad(
                sum((g * out[k]).sum() for g, k in zip(grads, TERMS)),
                (xa, ya))
            _close(torch, (fdx, fdy), (exp_dx, exp_dy), tol,
                   f"KDLoss.backward {N}x{V} {dtype}")
            e_f = _max_err(torch, (terms, stats), (exp_terms, exp_stats))
            e_b = _max_err(torch, (dx, dy), (exp_dx, exp_dy))
            errs[(N, V, dtype)] = (e_f, e_b)
            log(f"[kernels] {N}x{V} {dtype}: fwd max|err| {e_f:.3e}, bwd "
                f"max|err| {e_b:.3e} (tol {tol})")
    return errs


def _graph_ms(torch, fn, iters):
    """Device ms per call: `iters` calls captured into one CUDA graph, whose
    replay is timed with CUDA events. The host issues one replay, so its
    per-call cost (Python, the wrapper's checks, ctypes) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _eager_ms(torch, fn, iters):
    """Wall ms per call of back-to-back eager calls, ended by a sync: the
    host's issue cost when it exceeds the device's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kd_bounds(N, V, elt):
    """Least time (ms) the card could take for each kernel's work, as
    {name: (bound_ms, bound_by)}: bytes moved once over 3.35 TB/s against
    fp32 operations over 67 TFLOP/s, the larger of the two. Forward reads x,
    y (N*V each) and labels, writes 8 fp32 rows of N; it does 2 exp and
    about 10 fp32 operations per (x, y) element pair. Backward reads x, y,
    labels, 4 stats and 4 upstream rows, writes dx, dy; 2 exp and about 14
    operations per pair."""
    out = {}
    for name, nbytes, ops in (
            ("kd_loss_fwd", 2 * N * V * elt + 4 * N + 32 * N, 12 * N * V),
            ("kd_loss_bwd", 4 * N * V * elt + 4 * N + 32 * N, 16 * N * V)):
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        t_o = ops / PEAK_FP32_OPS_PER_S * 1e3
        out[name] = ((t_b, "bytes") if t_b >= t_o else (t_o, "operations"))
    return out


def phase_timing(torch, shapes):
    """{(kernel, N, V, dtype): times} at each shape, for the kernel and its
    plain version: device ms from graph replays, eager wall ms per call."""
    from repro_torch.kernels import kd_loss as kd, ref
    times = {}
    for N, V, dtype in shapes:
        x, y, lab, grads = _inputs(torch, N, V, dtype, seed=7)
        _, stats = kd.kd_loss_fwd(x, y, lab)
        iters = 200 if N * V < 1e6 else 20
        fns = {"kd_loss_fwd": (lambda: kd.kd_loss_fwd(x, y, lab),
                               lambda: ref.kd_loss_fwd_ref(x, y, lab)),
               "kd_loss_bwd": (
                   lambda: kd.kd_loss_bwd(x, y, lab, stats, grads),
                   lambda: ref.kd_loss_bwd_ref(x, y, lab, stats, grads))}
        bounds = kd_bounds(N, V, x.element_size())
        for name, (kernel, plain) in fns.items():
            # plain, kernel, kernel, plain: the two kernel and two plain
            # timings are averaged, so drift in clocks hits both alike
            p1 = _graph_ms(torch, plain, iters)
            k1 = _graph_ms(torch, kernel, iters)
            k2 = _graph_ms(torch, kernel, iters)
            p2 = _graph_ms(torch, plain, iters)
            k_eager = _eager_ms(torch, kernel, iters)
            p_eager = _eager_ms(torch, plain, iters)
            b_ms, b_by = bounds[name]
            times[(name, N, V, dtype)] = {
                "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                "bound_ms": b_ms, "bound_by": b_by,
                "eager_ms": k_eager, "plain_eager_ms": p_eager}
            log(f"[timing] {name} {N}x{V} {dtype}: kernel device "
                f"{(k1 + k2) / 2:.6f} ms ({k1:.6f}, {k2:.6f}), plain device "
                f"{(p1 + p2) / 2:.6f} ms, bound {b_ms:.7f} ms by {b_by} "
                f"(3.35 TB/s, 67 TFLOP/s fp32); eager wall per call: "
                f"kernel {k_eager:.6f} ms, plain {p_eager:.6f} ms")
    return times


# ---------------------------------------------------------------------- #
# 4. the main path
# ---------------------------------------------------------------------- #
def main_path_config():
    from repro_torch.fl import FLSimConfig
    # paper Table II: K=10 clients, k=6 per round, E=20, batch 32; the
    # cifar10 pool's large CNN is channels (32, 64, 128), hidden 128
    return FLSimConfig(dataset="cifar10", n_clients=10, k_per_round=6,
                       size_names=("small", "large"), default_epochs=20,
                       batch_size=32, batches_per_epoch=2)


def padded_steps(server, rec) -> dict:
    """{(N, V): launches} of one round, per kernel: each size group of the
    batched engine runs its padded step count S, one kd_loss call per step
    on C_p * B rows (C_p its padded client count, B its batch size)."""
    from repro_torch.fl.batched import BatchedClientEngine, next_pow2
    env = server.env
    bpe = env.cfg.batches_per_epoch
    groups = {}
    for c, s, tau in zip(rec.clients, rec.sizes, rec.intensities):
        key = (s, env.loaders[c].batch_size, next_pow2(tau * bpe))
        groups.setdefault(key, []).append(tau * bpe)
    out = {}
    for (_, batch, _), steps in groups.items():
        rows = BatchedClientEngine._client_pad(len(steps)) * batch
        shape = (rows, env.n_classes)
        out[shape] = out.get(shape, 0) + next_pow2(max(steps))
    return out


def _finite(torch, tree):
    from repro_torch.utils.pytree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def phase_main_path(torch):
    from repro_torch.fl import FLEnvironment, HAPFLServer
    from repro_torch.kernels import kd_loss as kd
    env = FLEnvironment(main_path_config())
    server = HAPFLServer(env, engine="batched", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kd.reset_launches()
    pre = server.pretrain_rl(10)
    log(f"[main] pretrain_rl(10): straggling {pre[0]['straggling']:.3f} -> "
        f"{pre[-1]['straggling']:.3f}")
    shapes, seconds = {}, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = server.run_round()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        steps = padded_steps(server, rec)
        for shape, n in steps.items():
            shapes[shape] = shapes.get(shape, 0) + n
        log(f"[main] round {rec.round_idx}: {seconds[-1]:.3f} s, sizes "
            f"{rec.sizes}, intensities {rec.intensities}, padded steps by "
            f"(rows, V) {steps}, straggling {rec.straggling:.3f}, acc_lite "
            f"{rec.acc_lite:.4f}, acc_by_size {rec.acc_by_size}")
    launches = dict(kd.launches)
    expected = sum(shapes.values())
    log(f"[main] launches {launches}, expected {expected} each, by (rows, "
        f"V) {shapes}")
    if launches != {"kd_loss_fwd": expected, "kd_loss_bwd": expected}:
        raise SystemExit(f"chip_smoke: launches {launches} != padded steps "
                         f"{expected} per kernel")
    if not (_finite(torch, server.lite_params)
            and all(_finite(torch, p) for p in server.global_by_size.values())):
        raise SystemExit("chip_smoke: non-finite global params")
    log(f"[main] seconds per round after the first {seconds[1:]}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    return server, launches, shapes


# ---------------------------------------------------------------------- #
# 6. the cohort on the card against the cohort on the CPU
# ---------------------------------------------------------------------- #
def phase_parity(torch):
    from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = FLSimConfig(dataset="cifar10", n_train=600, n_test=100,
                      n_clients=6, k_per_round=4, default_epochs=2,
                      batches_per_epoch=1, batch_size=16)
    servers = {dev: HAPFLServer(FLEnvironment(cfg), seed=2, use_ppo1=False,
                                use_ppo2=False, engine="batched",
                                device=dev) for dev in ("cuda", "cpu")}
    gpu, cpu = servers["cuda"], servers["cpu"]
    cpu.lite_params = tree_map(lambda t: t.cpu(), gpu.lite_params)
    cpu.global_by_size = {s: tree_map(lambda t: t.cpu(), p)
                          for s, p in gpu.global_by_size.items()}
    cohort = ([0, 1, 2, 3], ["small", "small", "large", "large"],
              [1, 3, 2, 1])
    with full_fp32(torch):
        out = {dev: srv.batched_engine.train_cohort(
                   *cohort, srv.global_by_size, srv.lite_params)
               for dev, srv in servers.items()}
        torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-3)
            err = max(err, float((la.cpu() - lb).abs().max()))
    log(f"[parity] cuda vs cpu cohort: max|diff| {err:.3e} "
        f"(atol 1e-4, rtol 1e-3)")


# ---------------------------------------------------------------------- #
# 7. where a round's device time goes
# ---------------------------------------------------------------------- #
def phase_profile(torch, server):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # rows of device-side events only (kernels, copies, memsets): an
    # operator's own row would count its kernels a second time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log(f"[profile] round {wall:.3f} s; device time not measured (the "
            "profiler recorded no device events)")
        return
    log(f"[profile] round {wall:.3f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the round; idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    for dev_us, count, key in rows[:12]:
        log(f"[profile] {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    # the port's own kernels, wherever they rank: device time per launch
    for dev_us, count, key in rows:
        for kernel in ("kd_fwd_kernel", "kd_bwd_kernel"):
            if kernel in key:
                log(f"[profile] {kernel}: {count} launches, "
                    f"{dev_us / 1e3:.3f} ms on the device, "
                    f"{dev_us / count:.2f} us per launch "
                    f"({100 * dev_us / 1e6 / busy:.2f}% of device time)")


def main_path_times(times, name, shapes):
    """One kernel's times over the main path, each the mean over the shapes
    it ran at weighted by its launches there; bound_by is that of the shape
    with the most launches."""
    total = sum(shapes.values())
    at = {s: times[(name, *s, "float32")] for s in shapes}
    out = {k: sum(at[s][k] * n for s, n in shapes.items()) / total
           for k in ("ms", "plain_ms", "bound_ms", "eager_ms",
                     "plain_eager_ms")}
    out["bound_by"] = at[max(shapes, key=shapes.get)]["bound_by"]
    return out


# ---------------------------------------------------------------------- #
def main() -> int:
    import torch
    card = phase_device(torch)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    errs = phase_kernels(torch, CHECK_SHAPES)
    server, launches, shapes = phase_main_path(torch)
    main = [(N, V, "float32") for N, V in sorted(shapes)]
    errs.update(phase_kernels(torch, [s for s in main if s not in errs]))
    times = phase_timing(torch, main + VOCAB_SHAPES)
    phase_parity(torch)
    phase_profile(torch, server)

    from repro_torch.kernels import kd_loss as kd
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
         "replaces": "src/repro/kernels/kd_loss.py:30",
         "launches": launches[name],
         "max_abs_err": max(errs[s][i] for s in main),
         **main_path_times(times, name, shapes),
         "library_ms": None,
         "shapes": [[N, V, n] for (N, V), n in sorted(shapes.items())],
         "dtype": "float32"}
        for i, name in enumerate(kd.launches)]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
