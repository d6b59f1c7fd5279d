#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch and CUDA versions.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc with nvcc (one process per
                source, all at once), print ptxas' register/spill report,
                and require HGMMA (wgmma) in the SASS of the bf16 flash
                kernels, forward and backward, and TMA loads (UTMALDG) and
                mbarrier waits (SYNCS) in the backward's (cuobjdump -sass of
                the built libraries).
  3. kernels  — hold each kernel against its plain PyTorch version:
                kd_loss_fwd / kd_loss_bwd at the HAPFL path's row counts (4
                and 8 padded clients x batch 32), a ragged N, a ragged V and
                a vocabulary shape in fp32 and bf16 (tolerances of
                tests/test_kernels.py: fp32 1e-4, bf16 5e-2); kd_loss_grad
                at (8, 32, 10), (4, 32, 10), V = 777 and the vocabulary
                shape (4, 512, 32000) in fp32 and bf16 at the same
                tolerances, its accuracies exact and two launches bitwise
                equal; rmsnorm at the serve path's (2048, 3072) and (4,
                3072), a ragged N and an odd d; add_rmsnorm at the same
                shapes bitwise equal to `x + delta` followed by the rmsnorm
                kernel; flash_attention at the serve path's prefill shape,
                both as contiguous (B, H, S, hd) tensors and as the
                transposed views of (B, S, H, hd) tensors that the path
                gives it, a ragged S, sliding windows, hd 64 and H = KV,
                in bf16 (the wgmma kernel) and fp32 (the SIMT kernel).
                rmsnorm and flash hold fp32 to 1e-5 and 2e-5:
                tests/test_kernels.py's 2e-6 assumes the CPU's order of
                summation, and the kernels sum in another. bf16 2e-2, as
                there. The backward kernels: rmsnorm_bwd and
                add_rmsnorm_bwd (with and without g_s) at the training
                path's (2048, 3072) and (2048, 256), a ragged N and an odd
                d, in bf16 and fp32, dscale at atol tol x sqrt(N) (a sum
                over N rows in another order); flash_attention_bwd at
                (4, 24, 8, 512, 128) and the lite's (4, 4, 4, 512, 64),
                S = 300, window 64 and 48, fp32 and bf16, both layouts.
                Two backward launches must be bitwise equal, and the flash
                forward's o the same bits with and without its lse; the
                norm backward, one launch, must replay under a CUDA graph
                bit for bit as it runs eagerly.
  4. HAPFL    — Algorithm 1 on the paper's cifar10 pool at full width
                (small + large CNNs, 10 clients, 6 per round): 10
                latency-only PPO pretraining rounds, then 3 training rounds
                through the batched engine. Launch counters are zeroed just
                before and read just after: kd_loss_grad must have launched
                exactly once per padded step of every size group, and
                kd_loss_fwd / kd_loss_bwd never. A shape the path gave the
                kernel that phase 3 did not check is checked now.
  4b. baselines — FedAvg, FedProx, pFedMe and FedDdrl (paper §V.B) at the
                same config through BaselineRunner on the card: 2 training
                rounds each (FedDdrl after 5 latency-only rounds, so that
                its PPO2 updates), seconds per round, acc_global and
                summary() logged, every global finite and no kernel
                launched (their loss is plain CE, no kd_loss). Then one
                FedProx and one pFedMe round on the card and on the CPU from
                the same globals: identical host records (clients,
                straggling, wall time), globals at atol 1e-4 / rtol 1e-3.
  4c. async   — examples/comm_efficient.py's setup at the same config: a
                HAPFL server with cross-size aggregation and the topk+int8
                codec (ratio 0.08, dense_min 256) under
                EventScheduler(BufferedPolicy(buffer_m=3)) with
                codec-priced links, fleet health and the tracer on, 4
                waves. Counters are zeroed just before and read just after:
                one kd_loss_grad per padded step of every wave; every
                wave's record carries rl_diag; each upload is under a
                quarter of its dense float32 bytes; the first aggregation
                moves both sizes' globals (small does not cover large, so
                the coverage-class path runs); globals finite. Then
                codec="identity" equals codec=None bit for bit for a round,
                and EventScheduler(SyncPolicy()).run(waves=2) equals
                server.run(2) (records, and globals bit for bit). The wall
                time of both phases is logged, and of the whole script.
  5. serve    — llama3.2-3b at full width (28 layers, d 3072, 24 heads, 8
                KV heads, vocab 128256) in bf16, random weights from a
                seeded generator on the card: ServeEngine(max_len=1024)
                .generate on 4 prompts x 512 tokens for 32 new tokens; the
                decode step is captured into a CUDA graph at the engine's
                first generate and replayed. Counters are zeroed just
                before the counted generate and read just after: rmsnorm
                1 + 32 = 33, add_rmsnorm (2 * 28) * (1 + 32) = 1848,
                flash_attention 28, kd 0. The graphed generate's tokens
                and each step's logits must equal, bit for bit, an eager
                loop of make_decode_step on the card from the same
                prefill; so must a 2-layer sliding-window cut whose ring
                buffer wraps under the graph. Prefill ms, decode ms per
                step graphed and eager, the graph replay's device ms per
                step, tokens/s and peak memory are printed.
  6. timing   — each kernel, its plain version and, where one PyTorch call
                computes the same function, that call (F.rms_norm,
                x + delta then F.rms_norm, F.scaled_dot_product_attention),
                at every shape and layout its path gave it. `ms` is device
                time: the calls are captured into one CUDA graph and its
                replay is timed with CUDA events, so the host's issue cost
                is left out. For the norms and flash the calls cycle over
                copies of their inputs that together spill
                the 50 MB L2, so that each call reads device memory, as the
                bound assumes; `warm_ms` reuses one copy. `eager_ms` is the
                wall time per call of back-to-back eager calls, the
                wrapper's host cost included.
  7. parity   — with PPO off and the same starting globals, one ragged
                cohort trained on the card (through the kernels) equals the
                same cohort trained on the CPU (plain versions); a 2-layer
                cut of the full-width llama in fp32 gives the same prefill
                logits and 4 decode steps' logits on the card and on the
                CPU (atol and rtol 1e-3).
  8. profile  — one more HAPFL training round, one more generate, its
                graphed decode loop alone and one prefill under
                torch.profiler: device time by kernel, the device's busy
                share, and the idle gaps between the decode loop's device
                work. The prefill must make no layout copy (aten::clone)
                of q, k, v or the attention output around the flash
                kernel.

  9. train    — llama3.2-3b at full width (bf16, remat) with its LiteModel
                through repro_torch.launch.train's functions: batch 4 x
                seq 512 of make_token_dataset tokens, AdamW at
                TrainStepConfig()'s defaults; a warm step, then 3 counted
                steps with exact launch counts derived from the config
                (train_launch_shapes: with remat each block's kernels run
                twice forward), finite loss and grad norm; seconds per
                step, tokens/s, peak memory; one more step under
                torch.profiler.
 10. fleet    — two LLMFleet rounds on the card (one kd_loss_grad per
                local step).
 11. parity   — one train step of a 2-layer fp32 cut of the full-width
                llama on the card and on the CPU (loss, metrics, grad norm,
                the grads of wq, the norm scales and the embedding, at
                1e-3), and one fleet round with injected sizes and
                intensities.
 12. timing   — the backward kernels at the training path's shapes beside
                their bounds, plain versions and the library's backward
                alone (F.rms_norm's; SDPA's with enable_gqa); the norm
                backward's and flash backward's device time by kernel (the
                norm backward must be one kernel); the flash forward with
                and without lse; kd_loss_grad at (1, 2048, 128256) fp32.

The parity phases turn TF32 off for cuDNN and matmuls, so that both sides
compute in full float32, and restore the defaults afterwards.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without CUDA, or run outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50e6                 # H100 L2 cache
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_NORM = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the main path calls kd_loss on C*B logit rows: C is a size group's client
# count padded to a power of two, at least 4; 6 clients per round give
# groups of 4 or 8 padded clients, at batch 32
# kd_loss_grad (C, B, V, dtype): the path's two group shapes, a ragged V
# and the vocabulary shape the LLM training slice will give it
GRAD_SHAPES = [(8, 32, 10, "float32"), (4, 32, 10, "float32"),
               (2, 32, 777, "float32"), (2, 32, 777, "bfloat16"),
               (4, 512, 32000, "float32"), (4, 512, 32000, "bfloat16"),
               (1, 2048, 128256, "float32")]
GRAD_VOCAB = [(4, 512, 32000, "float32"), (4, 512, 32000, "bfloat16")]
LAMBDAS = (0.4, 0.6, 0.5, 0.5)
CHECK_SHAPES = [(128, 10, "float32"), (256, 10, "float32"),
                (1000, 10, "float32"), (64, 777, "float32"),
                (2048, 32000, "float32"), (2048, 32000, "bfloat16")]
VOCAB_SHAPES = [(2048, 32000, "float32"), (2048, 32000, "bfloat16")]

# the serve path: llama3.2-3b at full width, 4 prompts x 512 tokens, 32 new
SERVE = {"arch": "llama3.2-3b", "batch": 4, "prompt": 512, "n_new": 32,
         "max_len": 1024, "seed": 0}
# its sliding-window cut: 2 layers, a 64-slot ring buffer that 40 decode
# steps after a 48-token prompt wrap around
WRAP = {"n_layers": 2, "window": 64, "prompt": 48, "n_new": 40}
# rmsnorm (N, d, dtype) and flash (B, H, KV, S, hd, window, dtype, layout)
# checks; layout "bshd" is the transposed view of (B, S, H, hd) tensors that
# the model passes, "bhsd" contiguous (B, H, S, hd) tensors
NORM_SHAPES = [(2048, 3072, "bfloat16"), (4, 3072, "bfloat16"),
               (2048, 256, "bfloat16"),
               (2048, 3072, "float32"), (4, 3072, "float32"),
               (1000, 3072, "bfloat16"), (1000, 3072, "float32"),
               (64, 777, "float32"), (64, 777, "bfloat16")]
FLASH_SHAPES = [(4, 24, 8, 512, 128, 0, "bfloat16", "bshd"),
                (4, 24, 8, 512, 128, 0, "float32", "bshd"),
                (4, 24, 8, 512, 128, 0, "bfloat16", "bhsd"),
                (4, 24, 8, 512, 128, 0, "float32", "bhsd"),
                (2, 24, 8, 300, 128, 0, "bfloat16", "bshd"),
                (2, 24, 8, 300, 128, 0, "float32", "bhsd"),
                (2, 8, 2, 512, 128, 64, "float32", "bhsd"),
                (2, 8, 2, 512, 128, 64, "bfloat16", "bshd"),
                (1, 4, 2, 300, 128, 100, "bfloat16", "bhsd"),
                (2, 8, 4, 256, 64, 0, "float32", "bhsd"),
                (2, 8, 4, 256, 64, 0, "bfloat16", "bshd"),
                (2, 8, 4, 300, 64, 48, "bfloat16", "bhsd"),
                (2, 8, 8, 256, 128, 0, "float32", "bhsd"),
                (2, 8, 8, 256, 128, 0, "bfloat16", "bhsd"),
                (4, 4, 4, 512, 64, 0, "bfloat16", "bshd")]

# the training path: llama3.2-3b at full width (bf16, remat, the config's
# own) with its LiteModel, batch 4 x seq 512, AdamW at TrainStepConfig()'s
# defaults; one warm step, then TRAIN["steps"] counted and timed ones
TRAIN = {"arch": "llama3.2-3b", "batch": 4, "seq": 512, "steps": 3,
         "seed": 0}
# backward checks: norms (N, d, dtype), flash as FLASH_SHAPES
NORM_BWD_SHAPES = [(2048, 3072, "bfloat16"), (2048, 3072, "float32"),
                   (2048, 256, "bfloat16"), (2048, 256, "float32"),
                   (1000, 3072, "bfloat16"), (1000, 3072, "float32"),
                   (64, 777, "float32"), (64, 777, "bfloat16")]
FLASH_BWD_SHAPES = [(4, 24, 8, 512, 128, 0, "bfloat16", "bshd"),
                    (4, 24, 8, 512, 128, 0, "float32", "bshd"),
                    (4, 4, 4, 512, 64, 0, "bfloat16", "bshd"),
                    (2, 24, 8, 300, 128, 0, "bfloat16", "bshd"),
                    (2, 8, 2, 512, 128, 64, "bfloat16", "bshd"),
                    (2, 8, 2, 512, 128, 64, "float32", "bhsd"),
                    (2, 8, 4, 300, 64, 48, "float32", "bshd"),
                    # grids of two blocks an SM or more: one dQ consumer
                    (4, 24, 8, 300, 128, 64, "bfloat16", "bshd"),
                    (8, 16, 4, 300, 64, 48, "bfloat16", "bhsd")]

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
    check_hgmma(_build)


def check_hgmma(_build):
    """The bf16 flash kernels must run on the tensor cores through wgmma,
    fed by TMA: every instantiation (one at least per head dim) of the
    forward's flash_wgmma_kernel and of the backward's
    flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel has HGMMA in
    its SASS, and the backward's also UTMALDG (cp.async.bulk.tensor) and
    SYNCS (mbarrier) instructions."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    wanted = {"flash_attention": ("flash_wgmma_kernel",),
              "flash_attention_bwd": ("flash_bwd_dkdv_wgmma_kernel",
                                      "flash_bwd_dq_wgmma_kernel")}
    for lib, kernels in wanted.items():
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts = {}
        for section in sass.split("Function : ")[1:]:
            name = section.splitlines()[0].strip()
            if any(k in name for k in kernels):
                counts[name] = {op: section.count(op)
                                for op in ("HGMMA", "UTMALDG", "SYNCS")}
        log(f"[build] HGMMA, UTMALDG and SYNCS instructions in the SASS of "
            f"{', '.join(kernels)}: {counts}")
        need = ("HGMMA",) if lib == "flash_attention" else (
            "HGMMA", "UTMALDG", "SYNCS")
        if (any(sum(k in name for name in counts) < len(HEAD_DIMS)
                for k in kernels)
                or not all(c[op] for c in counts.values() for op in need)):
            raise SystemExit(f"chip_smoke: a bf16 kernel of {lib} lacks "
                             f"{' or '.join(need)} in its SASS")


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


def _grad_inputs(torch, C, B, V, dtype, seed):
    x, y, lab, _ = _inputs(torch, C * B, V, dtype, seed)
    return x.view(C, B, V), y.view(C, B, V), lab.view(C, B)


def phase_kd_grad(torch, shapes):
    """{(C, B, V, dtype): max|err|} of kd_loss_grad against its plain
    version: dx, dy and the four loss means within the kd tolerances, the
    two accuracies exact, and two launches bitwise equal (its sums take a
    fixed order; no float atomics)."""
    from repro_torch.kernels import kd_loss as kd, ref
    errs = {}
    with full_fp32(torch):
        for C, B, V, dtype in shapes:
            x, y, lab = _grad_inputs(torch, C, B, V, dtype, seed=C * B + V)
            got = kd.kd_loss_grad(x, y, lab, LAMBDAS)
            again = kd.kd_loss_grad(x, y, lab, LAMBDAS)
            torch.cuda.synchronize()
            exp = ref.kd_loss_grad_ref(x, y, lab, LAMBDAS)
            what = f"kd_loss_grad {C}x{B}x{V} {dtype}"
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"chip_smoke: {what}: two launches on the "
                                 f"same inputs differ")
            if not torch.equal(got[2][4:], exp[2][4:]):
                raise SystemExit(f"chip_smoke: {what}: accuracies "
                                 f"{got[2][4:].tolist()} != "
                                 f"{exp[2][4:].tolist()}")
            tol = TOL[dtype]
            pairs = ((got[0], got[1], got[2][:4]), (exp[0], exp[1], exp[2][:4]))
            _close(torch, *pairs, tol, what)
            errs[(C, B, V, dtype)] = e = _max_err(torch, *pairs)
            log(f"[kernels] {what}: max|err| {e:.3e} (tol {tol}), "
                f"accuracies exact, two launches bitwise equal")
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


def grad_bound(C, B, V, elt):
    """kd_loss_grad: x, y read and dx, dy written once, labels read and the
    (6, C) means written; about 28 fp32 operations and 4 exps per (x, y)
    element pair (the forward's and the backward's, less what they
    share)."""
    N = C * B
    return _bound(4 * N * V * elt + 4 * N + 24 * C, 28 * N * V,
                  PEAK_FP32_OPS_PER_S)


def phase_grad_timing(torch, shapes, iters=None):
    """Times of kd_loss_grad and its plain version at each (C, B, V,
    dtype), over `iters` calls (by default 200, or 20 at a million logits
    and more); no single PyTorch call computes the same function."""
    from repro_torch.kernels import kd_loss as kd, ref
    times = {}
    for C, B, V, dtype in shapes:
        x, y, lab = _grad_inputs(torch, C, B, V, dtype, seed=7)
        fns = {"kernel": lambda: kd.kd_loss_grad(x, y, lab, LAMBDAS),
               "plain": lambda: ref.kd_loss_grad_ref(x, y, lab, LAMBDAS),
               "library": None, "kernel_warm": None}
        times[("kd_loss_grad", C, B, V, dtype)] = _time_set(
            torch, "kd_loss_grad", (C, B, V, dtype), fns,
            grad_bound(C, B, V, x.element_size()),
            iters or (200 if C * B * V < 1e6 else 20))
    return times


# ---------------------------------------------------------------------- #
# 3 and 6. rmsnorm and flash attention against their plain versions, and
# their times
# ---------------------------------------------------------------------- #
def _randn(torch, shape, dtype, g, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        getattr(torch, dtype))


def _norm_inputs(torch, N, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(N + d)
    return (_randn(torch, (N, d), dtype, g),
            (1 + _randn(torch, (d,), "float32", g, 0.1)).to(
                getattr(torch, dtype)))


def _add_norm_inputs(torch, N, d, dtype):
    x, sc = _norm_inputs(torch, N, d, dtype)
    g = torch.Generator(device="cuda").manual_seed(N * d)
    return x, _randn(torch, (N, d), dtype, g), sc


def _flash_inputs(torch, B, H, KV, S, hd, dtype, layout):
    """q (B, H, S, hd), k and v (B, KV, S, hd): contiguous for layout
    "bhsd", the transposed views of (B, S, H, hd) tensors for "bshd"."""
    g = torch.Generator(device="cuda").manual_seed(B * S + hd)
    if layout == "bhsd":
        return (_randn(torch, (B, H, S, hd), dtype, g),
                _randn(torch, (B, KV, S, hd), dtype, g),
                _randn(torch, (B, KV, S, hd), dtype, g))
    return tuple(_randn(torch, (B, S, n, hd), dtype, g).transpose(1, 2)
                 for n in (H, KV, KV))


def phase_norm_flash_kernels(torch):
    """{("rmsnorm", N, d, dtype) | ("flash_attention", B, H, KV, S, hd,
    window, dtype, layout): max|err|} against the plain versions."""
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    errs = {}
    with full_fp32(torch):
        for N, d, dtype in NORM_SHAPES:
            x, sc = _norm_inputs(torch, N, d, dtype)
            got = rn.rmsnorm(x, sc)
            torch.cuda.synchronize()
            exp = ref.rmsnorm_ref(x, sc)
            tol = TOL_NORM[dtype]
            _close(torch, (got,), (exp,), tol, f"rmsnorm {N}x{d} {dtype}")
            errs[("rmsnorm", N, d, dtype)] = e = _max_err(torch, (got,), (exp,))
            log(f"[kernels] rmsnorm {N}x{d} {dtype}: max|err| {e:.3e} "
                f"(tol {tol})")
        for N, d, dtype in NORM_SHAPES:
            x, delta, sc = _add_norm_inputs(torch, N, d, dtype)
            s, y = rn.add_rmsnorm(x, delta, sc)
            s2 = x + delta
            y2 = rn.rmsnorm(s2, sc)
            torch.cuda.synchronize()
            what = f"add_rmsnorm {N}x{d} {dtype}"
            if not (torch.equal(s, s2) and torch.equal(y, y2)):
                raise SystemExit(f"chip_smoke: {what} is not bitwise equal "
                                 f"to x + delta and the rmsnorm kernel")
            exp = ref.add_rmsnorm_ref(x, delta, sc)
            tol = TOL_NORM[dtype]
            _close(torch, (s, y), exp, tol, what)
            errs[("add_rmsnorm", N, d, dtype)] = e = _max_err(
                torch, (s, y), exp)
            log(f"[kernels] {what}: bitwise equal to x + delta and rmsnorm; "
                f"max|err| against the plain version {e:.3e} (tol {tol})")
        for B, H, KV, S, hd, window, dtype, layout in FLASH_SHAPES:
            q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
            got = fa.flash_attention(q, k, v, causal=True,
                                     sliding_window=window)
            torch.cuda.synchronize()
            exp = ref.flash_attention_ref(q, k, v, causal=True,
                                          sliding_window=window)
            tol = TOL_FLASH[dtype]
            what = (f"flash_attention B{B} H{H} KV{KV} S{S} hd{hd} "
                    f"window {window} {dtype} {layout}")
            _close(torch, (got,), (exp,), tol, what)
            key = ("flash_attention", B, H, KV, S, hd, window, dtype, layout)
            errs[key] = e = _max_err(torch, (got,), (exp,))
            log(f"[kernels] {what}: max|err| {e:.3e} (tol {tol})")
    return errs


def phase_bwd_kernels(torch):
    """{("rmsnorm_bwd" | "add_rmsnorm_bwd", N, d, dtype) |
    ("flash_attention_bwd", B, H, KV, S, hd, window, dtype, layout):
    max|err|} of the backward kernels against their plain closed forms at
    the norm and flash tolerances. dscale is a sum over N rows taken in
    another order than the plain version's, so its absolute tolerance is
    the norm tolerance times sqrt(N), the sum's spread. Two launches on the
    same inputs must be bitwise equal; the flash forward's o must be the
    same bits with and without its lse output, and lse must match the plain
    log-sum-exp at the fp32 flash tolerance."""
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    errs = {}
    with full_fp32(torch):
        for N, d, dtype in NORM_BWD_SHAPES:
            x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
            g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
            gs = _randn(torch, (N, d), dtype, g)
            tol = TOL_NORM[dtype]
            for name, run, plain in (
                    ("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(x, sc, dy),
                     lambda: ref.rmsnorm_bwd_ref(x, sc, dy)),
                    ("add_rmsnorm_bwd",
                     lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy),
                     lambda: ref.add_rmsnorm_bwd_ref(x, sc, gs, dy)),
                    ("add_rmsnorm_bwd (no g_s)",
                     lambda: rn.add_rmsnorm_bwd(x, sc, None, dy),
                     lambda: ref.add_rmsnorm_bwd_ref(x, sc, None, dy))):
                got, again = run(), run()
                torch.cuda.synchronize()
                what = f"{name} {N}x{d} {dtype}"
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise SystemExit(f"chip_smoke: {what}: two launches on "
                                     f"the same inputs differ")
                exp = plain()
                _close(torch, got[:1], exp[:1], tol, what)
                torch.testing.assert_close(
                    got[1].float(), exp[1].float(), atol=tol * N ** 0.5,
                    rtol=tol, msg=lambda m: f"{what} dscale: {m}")
                key = (name.split(" ")[0], N, d, dtype)
                e = _max_err(torch, got, exp)
                errs[key] = max(errs.get(key, 0.0), e)
                log(f"[kernels] {what}: max|err| {e:.3e} (tol {tol}; "
                    f"dscale atol {tol * N ** 0.5:.2e}), two launches "
                    f"bitwise equal")
        check_norm_bwd_graph(torch)
        for B, H, KV, S, hd, window, dtype, layout in FLASH_BWD_SHAPES:
            q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
            what = (f"flash_attention_bwd B{B} H{H} KV{KV} S{S} hd{hd} "
                    f"window {window} {dtype} {layout}")
            o, lse = fa._launch(q, k, v, True, window, with_lse=True)
            o_plain = fa._launch(q, k, v, True, window)
            if not torch.equal(o, o_plain):
                raise SystemExit(f"chip_smoke: {what}: the forward's o "
                                 f"differs with its lse output")
            _, exp_lse = ref.flash_attention_ref(
                q, k, v, sliding_window=window, return_lse=True)
            _close(torch, (lse,), (exp_lse,), TOL_FLASH["float32"],
                   f"{what} lse")
            g = torch.Generator(device="cuda").manual_seed(S * hd + 1)
            do = _randn(torch, (B, S, H, hd), dtype, g).transpose(1, 2)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                         sliding_window=window)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           sliding_window=window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"chip_smoke: {what}: two launches on the "
                                 f"same inputs differ")
            exp = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                              sliding_window=window)
            tol = TOL_FLASH[dtype]
            _close(torch, got, exp, tol, what)
            key = ("flash_attention_bwd", B, H, KV, S, hd, window, dtype,
                   layout)
            errs[key] = e = _max_err(torch, got, exp)
            log(f"[kernels] {what}: max|err| of dq, dk, dv {e:.3e} (tol "
                f"{tol}); o bitwise unchanged by lse; two launches bitwise "
                f"equal")
    return errs


def check_norm_bwd_graph(torch):
    """The norm backward, replayed from a CUDA graph, gives the bits of an
    eager launch on the same inputs: its dscale reduction's counters reset
    themselves within the launch."""
    from repro_torch.kernels import rmsnorm as rn
    N, d, dtype = NORM_BWD_SHAPES[0]
    x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
    g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
    gs = _randn(torch, (N, d), dtype, g)
    for name, run in (("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(x, sc, dy)),
                      ("add_rmsnorm_bwd",
                       lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy))):
        eager = run()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, eager)):
                raise SystemExit(f"chip_smoke: {name} {(N, d, dtype)} "
                                 f"replayed from a CUDA graph differs from "
                                 f"an eager launch")
        log(f"[kernels] {name} {(N, d, dtype)}: 3 CUDA-graph replays "
            f"bitwise equal to an eager launch")


def _bound(nbytes, ops, ops_per_s):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def norm_bound(N, d, elt):
    """rmsnorm: x read and y written once, scale read once; about 4 fp32
    operations per element (square-add, two multiplies, the cast)."""
    return _bound(2 * N * d * elt + d * elt, 4 * N * d, PEAK_FP32_OPS_PER_S)


def add_norm_bound(N, d, elt):
    """add_rmsnorm: x and delta read, s and y written once, scale read
    once; about 5 fp32 operations per element."""
    return _bound(4 * N * d * elt + d * elt, 5 * N * d, PEAK_FP32_OPS_PER_S)


def visible_pairs(S, causal, window):
    """(query, key) pairs the masks leave visible, for one head."""
    total = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo
    return total


def flash_bound(B, H, KV, S, hd, window, dtype, elt):
    """flash_attention: Q and O (B, H, S, hd) and K, V (B, KV, S, hd) moved
    once; QK^T and PV over the visible pairs, 2 operations per
    multiply-add, at the bf16 tensor-core rate for bf16 inputs and the fp32
    rate for fp32 ones (the softmax's exps are not counted)."""
    nbytes = (2 * B * H + 2 * B * KV) * S * hd * elt
    ops = 4 * hd * B * H * visible_pairs(S, True, window)
    rate = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_FP32_OPS_PER_S
    return _bound(nbytes, ops, rate)


def _time_set(torch, name, shape, fns, bound, iters):
    """fns: {"kernel", "plain", "library" (or None), "kernel_warm"} ->
    times dict. kernel, plain and library cycle over enough copies of
    their inputs to spill the L2 cache between two uses of one copy, so
    that each call reads its inputs from device memory, as the bound
    assumes; kernel_warm reuses one copy, which stays in L2 when it fits."""
    # plain, kernel, kernel, plain: the two kernel and two plain timings are
    # averaged, so drift in clocks hits both alike; the library call last
    p1 = _graph_ms(torch, fns["plain"], iters)
    k1 = _graph_ms(torch, fns["kernel"], iters)
    k2 = _graph_ms(torch, fns["kernel"], iters)
    p2 = _graph_ms(torch, fns["plain"], iters)
    lib = (_graph_ms(torch, fns["library"], iters)
           if fns["library"] is not None else None)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "bound_ms": bound[0], "bound_by": bound[1],
           "eager_ms": _eager_ms(torch, fns["kernel"], iters),
           "plain_eager_ms": _eager_ms(torch, fns["plain"], iters),
           "library_ms": lib,
           "warm_ms": (_graph_ms(torch, fns["kernel_warm"], iters)
                       if fns["kernel_warm"] is not None else None)}
    warm = ("" if out["warm_ms"] is None else
            f"; {out['warm_ms']:.6f} with its inputs in L2")
    log(f"[timing] {name} {shape}: kernel device {out['ms']:.6f} ms ({k1:.6f}, "
        f"{k2:.6f}{warm}), plain "
        f"device {out['plain_ms']:.6f} ms, library "
        f"{'none' if lib is None else f'{lib:.6f} ms'}, bound "
        f"{bound[0]:.7f} ms by {bound[1]}; eager wall per call: kernel "
        f"{out['eager_ms']:.6f} ms, plain {out['plain_eager_ms']:.6f} ms")
    return out


def _cold_copies(tensors, nbytes):
    """Clones of `tensors` (a call's inputs; the call moves `nbytes` in
    all), enough that cycling through them moves twice the L2 between two
    uses of one set, at most 64; returns a function giving the next set."""
    n = max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))
    sets = [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]
    order = itertools.cycle(range(n))
    return lambda: sets[next(order)]


def _sdpa(torch):
    """F.scaled_dot_product_attention with grouped KV heads: the library
    yardstick for flash_attention (timed only, never called by the port)."""
    import torch.nn.functional as F

    def call(q, k, v, window):
        if window:
            S = q.shape[2]
            i = torch.arange(S, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    return call


def phase_norm_flash_timing(torch, norm_shapes, add_shapes, flash_shapes):
    """Times of rmsnorm and add_rmsnorm at each (N, d, dtype) and of
    flash_attention at each (B, H, KV, S, hd, window, dtype, layout)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn

    def rms_norm(x, scale):
        return F.rms_norm(x, (x.shape[-1],), scale, 1e-5)

    def add_rms_norm(x, delta, scale):
        s = x + delta
        return s, rms_norm(s, scale)

    times = {}
    for N, d, dtype in norm_shapes:
        x, sc = _norm_inputs(torch, N, d, dtype)
        nxt = _cold_copies((x, sc), 2 * x.numel() * x.element_size())
        fns = {"kernel": lambda: rn.rmsnorm(*nxt()),
               "plain": lambda: ref.rmsnorm_ref(*nxt()),
               "library": lambda: rms_norm(*nxt()),
               "kernel_warm": lambda: rn.rmsnorm(x, sc)}
        times[("rmsnorm", N, d, dtype)] = _time_set(
            torch, "rmsnorm", (N, d, dtype), fns,
            norm_bound(N, d, x.element_size()), 200 if N * d < 1e6 else 50)
    for N, d, dtype in add_shapes:
        x, delta, sc = _add_norm_inputs(torch, N, d, dtype)
        nxt = _cold_copies((x, delta, sc), 4 * x.numel() * x.element_size())
        fns = {"kernel": lambda: rn.add_rmsnorm(*nxt()),
               "plain": lambda: ref.add_rmsnorm_ref(*nxt()),
               "library": lambda: add_rms_norm(*nxt()),
               "kernel_warm": lambda: rn.add_rmsnorm(x, delta, sc)}
        times[("add_rmsnorm", N, d, dtype)] = _time_set(
            torch, "add_rmsnorm", (N, d, dtype), fns,
            add_norm_bound(N, d, x.element_size()),
            200 if N * d < 1e6 else 50)
    sdpa = _sdpa(torch)
    for B, H, KV, S, hd, window, dtype, layout in flash_shapes:
        q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
        nxt = _cold_copies((q, k, v), (2 * q.numel() + k.numel()
                                       + v.numel()) * q.element_size())
        fns = {"kernel": lambda: fa.flash_attention(
                   *nxt(), causal=True, sliding_window=window),
               "plain": lambda: ref.flash_attention_ref(
                   *nxt(), causal=True, sliding_window=window),
               "library": lambda: sdpa(*nxt(), window),
               "kernel_warm": lambda: fa.flash_attention(
                   q, k, v, causal=True, sliding_window=window)}
        key = ("flash_attention", B, H, KV, S, hd, window, dtype, layout)
        times[key] = _time_set(
            torch, "flash_attention", key[1:], fns,
            flash_bound(B, H, KV, S, hd, window, dtype, q.element_size()), 10)
    return times


# ---------------------------------------------------------------------- #
# 4. the HAPFL path
# ---------------------------------------------------------------------- #
def main_path_config():
    from repro_torch.fl import FLSimConfig
    # paper Table II: K=10 clients, k=6 per round, E=20, batch 32; the
    # cifar10 pool's large CNN is channels (32, 64, 128), hidden 128
    return FLSimConfig(dataset="cifar10", n_clients=10, k_per_round=6,
                       size_names=("small", "large"), default_epochs=20,
                       batch_size=32, batches_per_epoch=2)


def padded_steps(server, rec) -> dict:
    """{(C_p, B, V): launches} of one round: each size group of the batched
    engine runs its padded step count S, one kd_loss_grad call per step on
    (C_p, B, V) logits (C_p its padded client count, B its batch size)."""
    from repro_torch.fl.batched import BatchedClientEngine, next_pow2
    env = server.env
    bpe = env.cfg.batches_per_epoch
    groups = {}
    for c, s, tau in zip(rec.clients, rec.sizes, rec.intensities):
        key = (s, env.loaders[c].batch_size, next_pow2(tau * bpe))
        groups.setdefault(key, []).append(tau * bpe)
    out = {}
    for (_, batch, _), steps in groups.items():
        shape = (BatchedClientEngine._client_pad(len(steps)), batch,
                 env.n_classes)
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
    reset_all_launches()
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
            f"(C, B, V) {steps}, straggling {rec.straggling:.3f}, acc_lite "
            f"{rec.acc_lite:.4f}, acc_by_size {rec.acc_by_size}")
    launches = dict(kd.launches)
    log(f"[main] other kernels' launches {all_launches()}")
    expected = {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                "kd_loss_grad": sum(shapes.values())}
    log(f"[main] launches {launches}, expected {expected}, by (C, B, V) "
        f"{shapes}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: launches {launches} != {expected}: "
                         f"one kd_loss_grad per padded step")
    if not (_finite(torch, server.lite_params)
            and all(_finite(torch, p) for p in server.global_by_size.values())):
        raise SystemExit("chip_smoke: non-finite global params")
    log(f"[main] seconds per round after the first {seconds[1:]}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    return server, launches, shapes


# ---------------------------------------------------------------------- #
# 4b. the paper's baselines and 4c. the event-driven async HAPFL waves
# ---------------------------------------------------------------------- #
BASELINES = ("fedavg", "fedprox", "pfedme", "fedddrl")
BASELINE_ROUNDS = 2       # training rounds per baseline
FEDDDRL_WARMUP = 5        # latency-only rounds first: PPO2's buffer (B = 5)
ASYNC_WAVES = 4


def _host_record(rec):
    """A BaselineRecord's host fields: what the latency model and the data
    streams decide, not the trained params."""
    return (rec.round_idx, sorted(rec.client_acc), rec.straggling,
            rec.wall_time, rec.latency_only)


def phase_baselines(torch):
    """FedAvg, FedProx, pFedMe and FedDdrl (paper §V.B) at the main path's
    config on the card: 2 training rounds each (FedDdrl after 5
    latency-only rounds), finite globals and no kd_loss launch (their loss
    is plain CE). Then one FedProx and one pFedMe round on the card and on
    the CPU from the same globals: identical host records, globals at atol
    1e-4 / rtol 1e-3."""
    from repro_torch.fl import BaselineRunner, FLEnvironment
    from repro_torch.utils.pytree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    reset_all_launches()
    for algo in BASELINES:
        runner = BaselineRunner(FLEnvironment(main_path_config()), algo,
                                device="cuda")
        if algo == "fedddrl":
            for _ in range(FEDDDRL_WARMUP):
                runner.run_round(latency_only=True)
        seconds = []
        for _ in range(BASELINE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = runner.run_round()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            log(f"[baselines] {algo} round {rec.round_idx}: "
                f"{seconds[-1]:.3f} s, straggling {rec.straggling:.3f}, "
                f"acc_global {rec.acc_global:.4f}")
        if not _finite(torch, runner.global_params):
            raise SystemExit(f"chip_smoke: {algo}: non-finite global")
        if algo == "fedddrl" and runner.intensity.agent.n_updates < 1:
            raise SystemExit("chip_smoke: fedddrl: PPO2 never updated")
        log(f"[baselines] {algo}: seconds per round {seconds}, summary "
            f"{runner.summary()}")
    launches = all_launches()
    log(f"[baselines] launches {launches}")
    if any(launches.values()):
        raise SystemExit(f"chip_smoke: the baselines launched kernels "
                         f"{launches}: their CE is no kd_loss")
    for algo in ("fedprox", "pfedme"):
        runners = {dev: BaselineRunner(FLEnvironment(main_path_config()),
                                       algo, device=dev)
                   for dev in ("cuda", "cpu")}
        gpu, cpu = runners["cuda"], runners["cpu"]
        cpu.global_params = tree_map(lambda t: t.cpu(), gpu.global_params)
        if algo == "pfedme":
            cpu.personal = {c: cpu.global_params for c in cpu.personal}
        with full_fp32(torch):
            recs = {dev: r.run_round() for dev, r in runners.items()}
            torch.cuda.synchronize()
        if _host_record(recs["cuda"]) != _host_record(recs["cpu"]):
            raise SystemExit(f"chip_smoke: {algo}: card and CPU records "
                             f"differ: {recs}")
        err = 0.0
        for a, b in zip(tree_leaves(gpu.global_params),
                        tree_leaves(cpu.global_params)):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
            err = max(err, float((a.cpu() - b).abs().max()))
        log(f"[baselines] {algo} cuda vs cpu: host records identical, "
            f"globals max|diff| {err:.3e} (atol 1e-4, rtol 1e-3)")
    wall = time.perf_counter() - t_phase
    log(f"[baselines] phase wall {wall:.2f} s")
    return wall


def _globals_equal(torch, a, b):
    from repro_torch.utils.pytree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves([a.lite_params, a.global_by_size]),
        tree_leaves([b.lite_params, b.global_by_size])))


def phase_async(torch, grad_errs):
    """examples/comm_efficient.py's setup on the main path's config: a
    HAPFL server with cross-size aggregation and the topk+int8 codec under
    the buffered policy (buffer 3) with codec-priced links, fleet health and
    the tracer on, 4 waves. Counters are zeroed just before and read just
    after: one kd_loss_grad per padded step of every wave. Every wave's
    record carries rl_diag; each client's uplink is under a quarter of its
    dense float32 bytes; the first aggregation moves both sizes' globals.
    Then, on the card: codec="identity" equals no codec bit for bit for a
    round, and the sync policy's 2 waves equal server.run(2). Each
    (C, B, V) the waves gave kd_loss_grad is held against its plain version
    (phase_kd_grad) unless phase 3 did."""
    from repro_torch.comm import make_codec
    from repro_torch.core.latency import make_comm_model
    from repro_torch.core.nested import covers_all
    from repro_torch.fl import FLEnvironment, HAPFLServer
    from repro_torch.kernels import kd_loss as kd
    from repro_torch.obs import trace
    from repro_torch.sim import BufferedPolicy, EventScheduler, SyncPolicy
    from repro_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    env = FLEnvironment(main_path_config())
    codec = make_codec("topk+int8", ratio=0.08, dense_min=256)
    server = HAPFLServer(env, aggregation="cross_size", codec=codec,
                         device="cuda")
    comm = make_comm_model(
        {s: float(c.num_params()) for s, c in env.pool.items()},
        float(env.lite_cfg.num_params()), env.cfg.n_clients, codec=codec,
        model_tensors={s: c.num_tensors() for s, c in env.pool.items()},
        lite_tensors=env.lite_cfg.num_tensors())
    if covers_all(env.pool["large"], env.pool["small"]):
        raise SystemExit("chip_smoke: small covers large: the coverage-class "
                         "path would not run")
    before = {s: [t.clone() for t in tree_leaves(p)]
              for s, p in server.global_by_size.items()}
    moved, apply, wave_s = [], server.apply_updates, []

    def first_moves(*a, **k):
        n = apply(*a, **k)
        if not moved:
            moved.append({s: any(not torch.equal(x, y) for x, y in zip(
                before[s], tree_leaves(server.global_by_size[s])))
                for s in before})
        return n
    server.apply_updates = first_moves
    train = server.train_wave

    def timed_train(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(*a, **k)
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
        return out
    server.train_wave = timed_train
    sched = EventScheduler(server, BufferedPolicy(buffer_m=3), comm=comm,
                           health=True)
    tracer = trace.enable()
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        res = sched.run(waves=ASYNC_WAVES)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(kd.launches)
    finally:
        trace.disable()
    server.apply_updates, server.train_wave = apply, train
    shapes = {}
    for rec in server.history:
        for shape, n in padded_steps(server, rec).items():
            shapes[shape] = shapes.get(shape, 0) + n
    expected = {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                "kd_loss_grad": sum(shapes.values())}
    log(f"[async] {res.summary()}")
    log(f"[async] {len(server.history)} waves in {run_s:.3f} s; train_wave "
        f"(training + codec round trip + client eval) seconds {wave_s}; "
        f"timing {res.timing}; trace events {len(tracer.events)}")
    log(f"[async] launches {launches}, expected {expected}, by (C, B, V) "
        f"{shapes}")
    if len(server.history) != ASYNC_WAVES or launches != expected:
        raise SystemExit(f"chip_smoke: async waves: launches {launches} != "
                         f"{expected}: one kd_loss_grad per padded step")
    if any(rec.rl_diag is None or set(rec.rl_diag) != {"ppo1", "ppo2"}
           for rec in server.history):
        raise SystemExit("chip_smoke: a traced wave has no rl_diag")
    log(f"[async] rl_diag of the last wave {server.history[-1].rl_diag}")
    ratios = []
    for info in sched._waves.values():
        plan = info["plan"]
        for c, s, wire in zip(plan.clients, plan.sizes, plan.wire_bytes):
            dense = 4.0 * (env.pool[s].num_params()
                           + env.lite_cfg.num_params())
            ratios.append(wire / dense)
    log(f"[async] wire bytes / dense float32 bytes per client: min "
        f"{min(ratios):.4f}, max {max(ratios):.4f} over {len(ratios)} "
        f"uploads; up_bytes {res.up_bytes}")
    if len(ratios) != res.n_updates or max(ratios) >= 0.25:
        raise SystemExit("chip_smoke: an upload is not under a quarter of "
                         "its dense bytes")
    if not moved or not all(moved[0].values()):
        raise SystemExit(f"chip_smoke: the first aggregation left a size's "
                         f"global unmoved: {moved}")
    if not (_finite(torch, server.lite_params)
            and all(_finite(torch, p) for p in server.global_by_size.values())):
        raise SystemExit("chip_smoke: async waves: non-finite globals")
    log(f"[async] first aggregation moved {moved[0]}; globals finite")

    # identity codec == no codec, and the sync policy == run(), on the card
    servers = [HAPFLServer(FLEnvironment(main_path_config()), seed=5,
                           codec=cd, device="cuda")
               for cd in (None, "identity")]
    recs = [srv.run_round() for srv in servers]
    same = (recs[0].clients, recs[0].sizes, recs[0].intensities,
            recs[0].acc_lite, recs[0].client_acc) == (
        recs[1].clients, recs[1].sizes, recs[1].intensities,
        recs[1].acc_lite, recs[1].client_acc)
    if not (same and _globals_equal(torch, *servers)):
        raise SystemExit("chip_smoke: codec='identity' is not bitwise "
                         "codec=None on the card")
    log("[async] codec='identity' == codec=None bit for bit (one round)")
    plain = HAPFLServer(FLEnvironment(main_path_config()), seed=6,
                        device="cuda")
    plain.run(2)
    synced = HAPFLServer(FLEnvironment(main_path_config()), seed=6,
                         device="cuda")
    EventScheduler(synced, SyncPolicy()).run(waves=2)
    for a, b in zip(plain.history, synced.history):
        if (dataclasses.asdict(a) != dataclasses.asdict(b)):
            raise SystemExit(f"chip_smoke: the sync policy's records differ "
                             f"from server.run's: {a} vs {b}")
    if len(synced.history) != 2 or not _globals_equal(torch, plain, synced):
        raise SystemExit("chip_smoke: the sync policy's globals are not "
                         "server.run's bit for bit")
    log("[async] EventScheduler(SyncPolicy()).run(waves=2) == "
        "server.run(2): records identical, globals bit for bit")
    grad_errs.update(phase_kd_grad(
        torch, [(C, B, V, "float32") for C, B, V in sorted(shapes)
                if (C, B, V, "float32") not in grad_errs]))
    wall = time.perf_counter() - t_phase
    log(f"[async] phase wall {wall:.2f} s")
    return launches, shapes, wall


def reset_all_launches():
    from repro_torch.kernels import flash_attention, kd_loss, rmsnorm
    for mod in (kd_loss, rmsnorm, flash_attention):
        mod.reset_launches()


def all_launches():
    from repro_torch.kernels import flash_attention, kd_loss, rmsnorm
    return {**kd_loss.launches, **rmsnorm.launches, **flash_attention.launches}


# ---------------------------------------------------------------------- #
# 5. the serve path: llama3.2-3b at full width
# ---------------------------------------------------------------------- #
def serve_launch_shapes(cfg):
    """{kernel: {shape: launches}} of one counted generate: every forward
    runs one rmsnorm (the first block's first norm) and 2 L add_rmsnorm
    (every other norm, each with the residual add before it), the last of
    which, before the unembedding, prefill applies to the last position
    only; prefill runs flash attention once per block, decode never."""
    B, S, n = SERVE["batch"], SERVE["prompt"], SERVE["n_new"]
    L, d, H, KV = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    return {"rmsnorm": {(B * S, d, "bfloat16"): 1, (B, d, "bfloat16"): n},
            "add_rmsnorm": {(B * S, d, "bfloat16"): 2 * L - 1,
                            (B, d, "bfloat16"): 1 + 2 * L * n},
            "flash_attention": {(B, H, KV, S, cfg.resolved_head_dim, 0,
                                 "bfloat16", "bshd"): L},
            "kd_loss_fwd": {}, "kd_loss_bwd": {}, "kd_loss_grad": {},
            "rmsnorm_bwd": {}, "add_rmsnorm_bwd": {},
            "flash_attention_bwd": {}}


def eager_decode(torch, engine, batch, n_new):
    """The engine's decode step run eagerly: the same prefill and cache set-up
    as `generate`, then n_new calls of make_decode_step's function with a 0-d
    position tensor. Returns the tokens (B, n_new) numpy, each step's logits
    (B, n_new, vocab) and the wall seconds of the decode loop."""
    from repro_torch.models.api import make_decode_cache
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.engine import _write_prefix
    cfg, params = engine.cfg, engine.params
    B, S = batch["tokens"].shape
    step = make_decode_step(cfg)
    with torch.no_grad():
        logits, pre = make_prefill_step(cfg)(params, batch)
        cache = make_decode_cache(cfg, B, engine.max_len, "cuda")
        for key in ("k", "v"):
            if cache["blocks"][key].shape != pre["blocks"][key].shape:
                _write_prefix(cache["blocks"][key], pre["blocks"][key])
        del pre
        tok = logits[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device="cuda")
        toks, kept = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_new):
            index.fill_(S + i)
            tok, lg, cache = step(params, {"tokens": tok[:, None]}, cache,
                                  index)
            toks.append(tok)
            kept.append(lg[:, -1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return torch.stack(toks, 1).cpu().numpy(), torch.stack(kept, 1), secs


def check_graph_is_eager(torch, engine, batch, n_new, what):
    """engine.generate (the captured decode step, replayed) against the
    eager loop of the same step from the same prefill: identical tokens and
    bitwise equal logits at every step. Returns the eager loop's seconds."""
    import numpy as np
    got, logits = engine.generate(batch, n_new=n_new, return_logits=True)
    toks, kept, secs = eager_decode(torch, engine, batch, n_new)
    same = [bool(torch.equal(logits[:, i], kept[:, i]))
            for i in range(n_new)]
    if not (np.array_equal(got, toks) and all(same)):
        diffs = [float((logits[:, i] - kept[:, i]).abs().max())
                 for i in range(n_new)]
        raise SystemExit(f"chip_smoke: {what}: the graphed generate differs "
                         f"from the eager decode loop: tokens equal "
                         f"{np.array_equal(got, toks)}, max|diff| of logits "
                         f"per step {diffs}")
    log(f"[serve] {what}: graphed generate == eager decode loop: tokens "
        f"identical, logits bitwise equal at all {n_new} steps")
    return secs


def phase_serve(torch):
    """Serve 4 x 512-token prompts for 32 new tokens; returns the engine,
    its batch, the counted launches and the expected shapes."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model, prefill
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.pytree import tree_leaves
    cfg = get_config(SERVE["arch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_model(torch.Generator("cuda").manual_seed(SERVE["seed"]),
                        cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
        f"(num_params() {cfg.num_params()} + norm scales), "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params))} "
        f"B, initialised in {time.perf_counter() - t0:.2f} s")
    B, S, n_new = SERVE["batch"], SERVE["prompt"], SERVE["n_new"]
    tokens = np.random.default_rng(SERVE["seed"]).integers(
        0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    engine = ServeEngine(cfg, params, max_len=SERVE["max_len"], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(batch, n_new=2)   # captures the decode step; warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    step = engine.decode_step_for(B)
    if step.graph is None:
        raise SystemExit("chip_smoke: the engine's decode step on the card "
                         "is not a CUDA graph")
    log(f"[serve] first generate(2), the decode step's capture included: "
        f"{first:.4f} s; launches per replay {step.launches}")

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    out = engine.generate(batch, n_new=n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()

    shapes = serve_launch_shapes(cfg)
    expected = {k: sum(v.values()) for k, v in shapes.items()}
    log(f"[serve] launches {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: serve launches {launches} != "
                         f"{expected}")
    if out.shape != (B, n_new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise SystemExit(f"chip_smoke: generate gave {out.shape} tokens in "
                         f"[{out.min()}, {out.max()}]")
    with torch.no_grad():
        logits, _ = prefill(params, cfg, batch)
    if logits.shape != (B, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit("chip_smoke: prefill logits are not finite of "
                         "shape (B, 1, vocab)")
    eager_s = check_graph_is_eager(torch, engine, batch, n_new,
                                   f"{cfg.name} at full width")
    # prefill + one decode step, and 31 more decode steps: the difference
    # is the decode time per token
    runs = {}
    for n in (1, n_new, n_new, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(batch, n_new=n)
        torch.cuda.synchronize()
        runs.setdefault(n, []).append(time.perf_counter() - t0)
    t1, tn = (sum(runs[n]) / 2 for n in (1, n_new))
    decode_ms = (tn - t1) / (n_new - 1) * 1e3
    prefill_ms = t1 * 1e3 - decode_ms
    eager_ms = [eager_s * 1e3 / n_new,
                eager_decode(torch, engine, batch, n_new)[2] * 1e3 / n_new]
    # the graph's own device time per step: replays timed by CUDA events
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n_new):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / n_new
    log(f"[serve] counted generate {wall:.4f} s; generate(1) {runs[1]} s, "
        f"generate({n_new}) {runs[n_new]} s -> prefill {prefill_ms:.3f} ms "
        f"({B * S / prefill_ms * 1e3:.0f} prompt tokens/s), decode "
        f"{decode_ms:.3f} ms per step of {B} tokens graphed (graph replay "
        f"device time {replay_ms:.3f} ms per step), eager decode loop "
        f"{eager_ms[0]:.3f} and {eager_ms[1]:.3f} ms per step; "
        f"{B * n_new / tn:.1f} generated tokens/s over generate({n_new}); "
        f"max_memory_allocated {peak} B; first row {out[0][:8].tolist()}")
    return engine, batch, launches, shapes


def phase_serve_wrap(torch):
    """A 2-layer cut of the full-width config with a sliding window: the
    graphed generate crosses the ring buffer's wrap and still equals the
    eager decode loop bit for bit."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config(SERVE["arch"]),
                              n_layers=WRAP["n_layers"],
                              sliding_window=WRAP["window"])
    params = init_model(torch.Generator("cuda").manual_seed(3), cfg, "cuda")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE["batch"], WRAP["prompt"]))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    engine = ServeEngine(cfg, params, max_len=SERVE["max_len"], device="cuda")
    ring = engine.decode_step_for(SERVE["batch"]).cache["blocks"]["k"]
    last = WRAP["prompt"] + WRAP["n_new"] - 1
    if not (ring.shape[2] == WRAP["window"] < last):
        raise SystemExit(f"chip_smoke: the ring buffer {tuple(ring.shape)} "
                         f"does not wrap before position {last}")
    check_graph_is_eager(
        torch, engine, batch, WRAP["n_new"],
        f"{WRAP['n_layers']}-layer cut, window {WRAP['window']}, positions "
        f"{WRAP['prompt']}..{last} (the ring wraps at {WRAP['window']})")


def phase_serve_parity(torch):
    """A 2-layer fp32 cut of the full-width config, the same weights on the
    card and on the CPU: prefill logits and 4 decode steps' logits, each
    step fed the CPU's greedy token on both sides."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.api import (decode_step, init_model,
                                        make_decode_cache, prefill)
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2,
                              dtype=torch.float32)
    B, S, steps = 2, 128, 4
    gpu = init_model(torch.Generator("cuda").manual_seed(1), cfg, "cuda")
    sides = {"cuda": gpu,
             "cpu": params_from_numpy(params_to_numpy(gpu), device="cpu")}
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    err, agree = 0.0, 0
    with full_fp32(torch), torch.no_grad():
        logits, caches = {}, {}
        for dev, params in sides.items():
            logits[dev], pre = prefill(params, cfg, {
                "tokens": torch.as_tensor(tok, device=dev)})
            caches[dev] = make_decode_cache(cfg, B, S + steps, dev)
            for key in ("k", "v"):
                caches[dev]["blocks"][key][:, :, :S] = pre["blocks"][key]
        for i in range(steps + 1):
            a, b = logits["cuda"].cpu(), logits["cpu"]
            # fp32 on both sides, summed in other orders over rows of
            # 3072-8192: ten times the 1e-4 the CPU port keeps to the JAX
            # reference at the smoke config's d 256
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            err = max(err, float((a - b).abs().max()))
            nxt = b[:, -1].argmax(-1)
            agree += int((a[:, -1].argmax(-1) == nxt).sum())
            if i == steps:
                break
            for dev, params in sides.items():
                logits[dev], caches[dev] = decode_step(
                    params, cfg, {"tokens": nxt[:, None].to(dev)},
                    caches[dev], S + i)
    log(f"[parity] serve, 2-layer fp32 cut at full width, B {B}, S {S}: "
        f"prefill + {steps} decode steps, max|diff| of logits {err:.3e} "
        f"(atol 1e-3, rtol 1e-3); greedy tokens agree {agree} of "
        f"{B * (steps + 1)}")


# ---------------------------------------------------------------------- #
# 7. the cohort on the card against the cohort on the CPU
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
def phase_profile(torch, label, run, kernels, record_shapes=False):
    """Run `run()` once under torch.profiler and print the device's busy
    share of its wall time, the top kernels and the port's own `kernels`;
    returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run()
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
        log(f"[profile] {label} {wall:.3f} s; device time not measured (the "
            "profiler recorded no device events)")
        return prof
    log(f"[profile] {label} {wall:.3f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the {label}; idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    for dev_us, count, key in rows[:12]:
        log(f"[profile] {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    # the port's own kernels, wherever they rank: device time per launch
    for dev_us, count, key in rows:
        for kernel in kernels:
            if kernel in key:
                log(f"[profile] {kernel}: {count} launches, "
                    f"{dev_us / 1e3:.3f} ms on the device, "
                    f"{dev_us / count:.2f} us per launch "
                    f"({100 * dev_us / 1e6 / busy:.2f}% of device time)")
    return prof


def decode_loop(torch, engine, start, n):
    """generate's decode loop alone, on the cache the engine's last
    generate left: per step, set the position, replay, keep the token."""
    step = engine.decode_step_for(SERVE["batch"])
    out = torch.empty((SERVE["batch"], n), dtype=torch.int64, device="cuda")
    for i in range(n):
        step.index.fill_(start + i)
        step.step()
        out[:, i] = step.tokens[:, 0]
    return out


def report_device_gaps(torch, prof, label):
    """The device's timeline in `prof`: the union of its events' intervals
    from the first start to the last end, and the idle gaps between them."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.time_range.end > ev.time_range.start)
    if not spans:
        log(f"[profile] {label}: idle gaps not measured (no device events)")
        return
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(b[0] - a[1] for a, b in zip(merged, merged[1:]))
    span = merged[-1][1] - merged[0][0]
    busy = sum(b - a for a, b in merged)
    big = [g for g in gaps if g > 5]
    log(f"[profile] {label}: device timeline {span / 1e3:.3f} ms from the "
        f"first to the last device event, busy {busy / 1e3:.3f} ms "
        f"({100 * busy / span:.1f}%), {len(gaps)} idle gaps summing "
        f"{sum(gaps) / 1e3:.3f} ms; {len(big)} above 5 us (sum "
        f"{sum(big) / 1e3:.3f} ms, largest {gaps[-1] if gaps else 0:.1f} us, "
        f"median {gaps[len(gaps) // 2] if gaps else 0:.1f} us)")


def check_no_layout_copies(torch, prof, cfg):
    """The prefill must hand the flash kernel its q, k, v as views and take
    its output as one: no aten::clone (what .contiguous() and a reshape
    that cannot be a view call) of a tensor of the attention's shapes,
    (B, H, S, hd), (B, KV, S, hd) or (B, S, H, hd)."""
    B, S = SERVE["batch"], SERVE["prompt"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    layouts = {(B, H, S, hd), (B, KV, S, hd), (B, S, H, hd)}
    clones = [(ev.count, ev.input_shapes)
              for ev in prof.key_averages(group_by_input_shape=True)
              if ev.key == "aten::clone" and ev.input_shapes
              and tuple(ev.input_shapes[0]) in layouts]
    copies = [(ev.count, ev.self_device_time_total, ev.key)
              for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "copy" in ev.key.lower()]
    log(f"[profile] prefill: layout copies around flash (aten::clone at "
        f"{sorted(layouts)}): {clones or 'none'}; copy kernels in all: "
        f"{sum(c[0] for c in copies)} launches, "
        f"{sum(c[1] for c in copies) / 1e3:.3f} ms of device time")
    if clones:
        raise SystemExit(f"chip_smoke: prefill copies attention tensors "
                         f"around the flash kernel: {clones}")


# ---------------------------------------------------------------------- #
# 9-12. the training path: llama3.2-3b at full width, the LLM fleet, their
# card-vs-CPU parity, and the backward kernels' times
# ---------------------------------------------------------------------- #
TRAIN_KERNELS = ("rmsnorm", "add_rmsnorm", "rmsnorm_bwd", "add_rmsnorm_bwd",
                 "flash_attention", "flash_attention_bwd", "kd_loss_grad",
                 "kd_loss_fwd", "kd_loss_bwd")


def train_launch_shapes(cfg, lite):
    """{kernel: {shape: launches}} of one training step on (B, S) tokens.
    Per model of L blocks, with remat every block's forward runs twice (its
    forward, then again in the backward): rmsnorm (the first block's first
    norm) 2 and its backward 1; add_rmsnorm (every other norm of the
    blocks) 2 (2L - 1), plus the final norm, outside the blocks, once; its
    backward 2L; flash 2L and its backward L. Without remat the forwards
    run once. Both models' logits go to one kd_loss_grad launch on
    (1, B S, V)."""
    B, S = TRAIN["batch"], TRAIN["seq"]
    out = {k: {} for k in TRAIN_KERNELS}

    def add(name, shape, n):
        out[name][shape] = out[name].get(shape, 0) + n

    for c in (cfg, lite):
        L, r = c.n_layers, 2 if c.remat else 1
        dt = str(c.dtype).removeprefix("torch.")
        norm = (B * S, c.d_model, dt)
        flash = (B, c.n_heads, c.n_kv_heads, S, c.resolved_head_dim,
                 c.sliding_window, dt, "bshd")
        add("rmsnorm", norm, r)
        add("rmsnorm_bwd", norm, 1)
        add("add_rmsnorm", norm, r * (2 * L - 1) + 1)
        add("add_rmsnorm_bwd", norm, 2 * L)
        add("flash_attention", flash, r * L)
        add("flash_attention_bwd", flash, L)
    add("kd_loss_grad", (1, B * S, cfg.vocab_size, "float32"), 1)
    return out


def phase_train(torch):
    """llama3.2-3b at full width with its LiteModel through
    repro_torch.launch.train's functions: one warm step, then
    TRAIN["steps"] counted and timed steps. Returns the state, the step,
    the batches, the counted launches and the expected shapes per step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches
    from repro_torch.train import (TrainStepConfig, make_hapfl_train_step,
                                   make_train_state)
    from repro_torch.utils.pytree import tree_leaves
    cfg = get_config(TRAIN["arch"])
    lite = cfg.lite()
    tcfg = TrainStepConfig()
    B, S, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = make_train_state(
        torch.Generator("cuda").manual_seed(TRAIN["seed"]), cfg, lite, tcfg,
        "cuda")
    torch.cuda.synchronize()
    params = tree_leaves(state["params"])
    log(f"[train] {cfg.name} (remat {cfg.remat}, {cfg.dtype}) + "
        f"{lite.name} ({lite.n_layers} layers, d {lite.d_model}, "
        f"{lite.n_heads} heads, hd {lite.resolved_head_dim}): "
        f"{sum(t.numel() for t in params)} parameters, "
        f"{sum(t.numel() * t.element_size() for t in params)} B, AdamW "
        f"lr {tcfg.lr}, grad clip {tcfg.grad_clip}; state made in "
        f"{time.perf_counter() - t0:.2f} s")
    step = make_hapfl_train_step(cfg, lite, tcfg)
    batches = list(token_batches(cfg, B, S, 1 + n, TRAIN["seed"],
                                 device="cuda"))
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    log(f"[train] warm step {time.perf_counter() - t0:.3f} s, loss "
        f"{float(m['loss']):.4f}")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    secs, rows = [], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in m.items()})
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    shapes = train_launch_shapes(cfg, lite)
    expected = {k: n * sum(v.values()) for k, v in shapes.items()}
    log(f"[train] launches over {n} steps {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: train launches {launches} != "
                         f"{expected}")
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()):
            raise SystemExit(f"chip_smoke: non-finite training metrics {r}")
        log(f"[train] metrics {r}")
    if not _finite(torch, state["params"]):
        raise SystemExit("chip_smoke: non-finite params after training")
    mean = sum(secs) / n
    log(f"[train] seconds per step after the first {secs} (mean "
        f"{mean:.4f}), {B * S / mean:.1f} tokens/s ({B} x {S} tokens a "
        f"step), max_memory_allocated {peak} B")
    return state, step, batches, launches, shapes


def phase_fleet(torch):
    """Two LLMFleet rounds on the card at the reference's own size (the fp32
    smoke cut): one kd_loss_grad launch per local step, finite globals."""
    from repro_torch.fl.llm_fleet import FleetConfig, LLMFleet
    fleet = LLMFleet(FleetConfig(), device="cuda")
    reset_all_launches()
    steps = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = fleet.run_round()
        torch.cuda.synchronize()
        steps += sum(rec["taus"])
        log(f"[fleet] round {rec['round']}: {time.perf_counter() - t0:.3f} "
            f"s, {rec}")
    launches = all_launches()
    log(f"[fleet] launches {launches}")
    if launches["kd_loss_grad"] != steps:
        raise SystemExit(f"chip_smoke: fleet kd_loss_grad launches "
                         f"{launches['kd_loss_grad']} != {steps} local steps")
    if not (_finite(torch, fleet.lite_params) and all(
            _finite(torch, p) for p in fleet.global_by_size.values())):
        raise SystemExit("chip_smoke: non-finite fleet params")


def _assert_trees_close(torch, got, exp, tol, what, held=None):
    """Leaf by leaf at atol = rtol = tol; with `held` (a tree of bool masks
    like `exp`) only the elements it marks."""
    from repro_torch.utils.pytree import tree_leaves
    err = 0.0
    masks = tree_leaves(held) if held is not None else [None] * len(
        tree_leaves(exp))
    for a, b, mask in zip(tree_leaves(got), tree_leaves(exp), masks):
        a, b = a.detach().cpu().float(), b.detach().cpu().float()
        if mask is not None:
            a, b = a[mask], b[mask]
        if a.numel():
            err = max(err, float((a - b).abs().max()))
        torch.testing.assert_close(a, b, atol=tol, rtol=tol,
                                   msg=lambda m: f"{what}: {m}")
    return err


def phase_train_parity(torch):
    """One train step of a 2-layer fp32 cut of the full-width llama (and
    its LiteModel, remat as the config's), the same weights and tokens on
    the card and on the CPU: loss, metrics and grad norm, and the gradients
    of wq, the norm scales and the embedding (both models), at atol and
    rtol 1e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.train import token_batches
    from repro_torch.optim import adamw, global_norm
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_hapfl_train_step, make_train_state)
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=2,
                              dtype=torch.float32)
    lite = cfg.lite()
    tcfg = TrainStepConfig()
    gpu = make_train_state(torch.Generator("cuda").manual_seed(4), cfg, lite,
                           tcfg, "cuda")
    cpu_params = params_from_numpy(params_to_numpy(gpu["params"]), "cpu")
    states = {"cuda": gpu, "cpu": {"params": cpu_params,
                                   "opt": adamw(tcfg.lr).init(cpu_params)}}
    out = {}
    with full_fp32(torch):
        for dev, state in states.items():
            batch = next(token_batches(cfg, 2, 64, 1, seed=4, device=dev))
            metrics, grads = loss_and_grads(state["params"], cfg, lite, tcfg,
                                            batch)
            picked = [grads[m]["blocks"]["attn"]["wq"] for m in ("local",
                                                                 "lite")]
            picked += [grads[m]["blocks"][k]["scale"]
                       for m in ("local", "lite") for k in ("norm1", "norm2")]
            picked += [grads[m]["io"][k] if k == "embed" else
                       grads[m]["io"][k]["scale"]
                       for m in ("local", "lite") for k in ("embed", "norm_f")]
            gn = global_norm(grads)
            del grads
            _, m2 = make_hapfl_train_step(cfg, lite, tcfg)(state, batch)
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        float(gn), [t.cpu() for t in picked],
                        {k: float(v) for k, v in m2.items()})
        torch.cuda.synchronize()
    (ma, gna, pa, sa), (mb, gnb, pb, sb) = out["cuda"], out["cpu"]
    for k in mb:
        if not math.isclose(ma[k], mb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: train parity {k}: card {ma[k]} "
                             f"cpu {mb[k]}")
    for k in ("loss", "grad_norm"):
        if not math.isclose(sa[k], sb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: train step parity {k}: card "
                             f"{sa[k]} cpu {sb[k]}")
    if not math.isclose(gna, gnb, rel_tol=1e-3, abs_tol=1e-3):
        raise SystemExit(f"chip_smoke: grad norm card {gna} cpu {gnb}")
    err = _assert_trees_close(torch, pa, pb, 1e-3, "train parity grads")
    log(f"[parity] train, 2-layer fp32 cut at full width (B 2, S 64): loss "
        f"card {ma['loss']:.6f} cpu {mb['loss']:.6f}, grad norm "
        f"{gna:.6f} / {gnb:.6f}, the step's {sa['loss']:.6f} / "
        f"{sb['loss']:.6f}; grads of wq, the norm scales and the embedding "
        f"(both models) max|diff| {err:.3e} (atol 1e-3, rtol 1e-3)")


def phase_fleet_parity(torch):
    """One LLMFleet round on the card and on the CPU from the same globals,
    with the sizes and intensities injected: clients, sizes, taus and
    straggling equal, and the aggregated lite and size globals at 1e-3
    wherever the CPU's gradient was at least 1e-5 in size at every local
    step that fed them: Adam's first step moves a parameter by about lr
    times the sign of its gradient, so float noise in a near-zero gradient
    becomes a move of +-lr. At least 70% of each aggregate is held."""
    from repro_torch.fl.llm_fleet import FleetConfig, LLMFleet
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = dict(n_clients=4, k_per_round=2, seq=32, batch=2, default_steps=2)
    fleets = {dev: LLMFleet(FleetConfig(**cfg), device=dev)
              for dev in ("cuda", "cpu")}
    gpu, cpu = fleets["cuda"], fleets["cpu"]
    cpu.lite_params = tree_map(lambda t: t.cpu(), gpu.lite_params)
    cpu.global_by_size = {s: tree_map(lambda t: t.cpu(), p)
                          for s, p in gpu.global_by_size.items()}
    sizes, taus = ["small", "large"], [2, 1]
    g_min = {}    # the least |g| of each element over the CPU's local steps

    def recorded(s, step):
        def run(state, batch):
            _, g = loss_and_grads(state["params"], cpu.pool[s], cpu.lite,
                                  cpu.tcfg, batch)
            for name, tree in (("lite", g["lite"]), (s, g["local"])):
                size = tree_map(torch.abs, tree)
                g_min[name] = size if name not in g_min else tree_map(
                    torch.minimum, g_min[name], size)
            return step(state, batch)
        return run

    cpu._steps = {s: recorded(s, f) for s, f in cpu._steps.items()}
    recs = {}
    with full_fp32(torch):
        for dev, f in fleets.items():
            f.allocator.allocate = lambda gen, assess: (sizes, None)
            f.intensity.assign = lambda gen, modified: (taus, None)
            f.allocator.feedback = f.intensity.feedback = lambda *a: 0.0
            recs[dev] = f.run_round()
        torch.cuda.synchronize()
    for k in ("clients", "sizes", "taus", "straggling"):
        if recs["cuda"][k] != recs["cpu"][k]:
            raise SystemExit(f"chip_smoke: fleet parity {k}: "
                             f"{recs['cuda'][k]} != {recs['cpu'][k]}")
    trees = {"lite": (gpu.lite_params, cpu.lite_params)}
    trees.update({s: (gpu.global_by_size[s], cpu.global_by_size[s])
                  for s in set(sizes)})
    err, shares = 0.0, []
    for name, (got, exp) in trees.items():
        held = tree_map(lambda g: g >= 1e-5, g_min[name])
        n_held = sum(int(m.sum()) for m in tree_leaves(held))
        n_all = sum(m.numel() for m in tree_leaves(held))
        shares.append(f"{name} {n_held / n_all:.3f}")
        if n_held < 0.7 * n_all:
            raise SystemExit(f"chip_smoke: fleet parity {name}: only "
                             f"{n_held} of {n_all} elements held")
        err = max(err, _assert_trees_close(torch, got, exp, 1e-3,
                                           f"fleet parity {name}", held))
    log(f"[parity] fleet round, sizes {sizes} and taus {taus} injected: "
        f"clients, sizes, taus and straggling equal; accuracies card "
        f"{recs['cuda']['acc_local_mean']:.4f} / "
        f"{recs['cuda']['acc_lite_mean']:.4f}, cpu "
        f"{recs['cpu']['acc_local_mean']:.4f} / "
        f"{recs['cpu']['acc_lite_mean']:.4f}; aggregated params max|diff| "
        f"{err:.3e} (atol and rtol 1e-3 where every CPU step's |g| >= 1e-5;"
        f" held shares {', '.join(shares)})")


def norm_bwd_bound(N, d, elt, add):
    """rmsnorm_bwd: x, dy read and dx written once (add_rmsnorm_bwd: s,
    g_s, g_y read and d_s written), scale read and dscale written once;
    about 10 fp32 operations per element."""
    return _bound((4 if add else 3) * N * d * elt + 2 * d * elt, 10 * N * d,
                  PEAK_FP32_OPS_PER_S)


def flash_bwd_bound(B, H, KV, S, hd, window, dtype, elt):
    """flash_attention_bwd: q, o, dO, dq (B, H, S, hd) and k, v, dk, dv
    (B, KV, S, hd) moved once, lse read once; five products over the
    visible pairs (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K), 2
    operations per multiply-add, at the bf16 tensor-core rate for bf16
    inputs and the fp32 rate for fp32 ones."""
    nbytes = (4 * B * H + 4 * B * KV) * S * hd * elt + 4 * B * H * S
    ops = 10 * hd * B * H * visible_pairs(S, True, window)
    rate = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_FP32_OPS_PER_S
    return _bound(nbytes, ops, rate)


def _backward_ms(torch, fwd, nxt, iters):
    """Device ms of a PyTorch function's backward alone: graph replays of
    its forward and backward together, less those of its forward alone.
    nxt() gives (inputs, upstream gradients)."""
    def both():
        ins, grads = nxt()
        ins = [t.detach().requires_grad_(True) for t in ins]
        torch.autograd.grad(fwd(*ins), ins, grads)

    def forward():
        ins, _ = nxt()
        fwd(*[t.detach().requires_grad_(True) for t in ins])
    return _graph_ms(torch, both, iters) - _graph_ms(torch, forward, iters)


def kernel_split(torch, label, call, iters):
    """Device ms per launch of each kernel that `call()` launches (each
    launches once a call): `iters` eager calls under torch.profiler, each
    kernel's device time summed by name and divided by the launches the
    profiler recorded; beside it the whole call's device ms from CUDA events
    around a graph of `iters` calls. Returns {kernel: ms}."""
    from torch.profiler import ProfilerActivity, profile
    total = _graph_ms(torch, call, iters)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    split = {ev.key: ev.self_device_time_total / 1e3 / ev.count
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and ev.self_device_time_total > 0}
    log(f"[timing] {label}: {total:.6f} ms a call (CUDA events over a graph "
        f"of {iters}); by kernel (profiler, eager calls): "
        + ("; ".join(f"{k[:60]} {v:.6f} ms" for k, v in split.items())
           or "not measured (the profiler recorded no device events)"))
    return split


def phase_norm_bwd_split(torch, shapes):
    """kernel_split of rmsnorm_bwd and add_rmsnorm_bwd at each (N, d,
    dtype), their inputs cycled L2-cold as in _time_set: the backward must
    be one kernel."""
    from repro_torch.kernels import rmsnorm as rn
    out = {}
    for N, d, dtype in shapes:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
        gs = _randn(torch, (N, d), dtype, g)
        nxt = _cold_copies((x, sc, gs, dy), 4 * x.numel() * x.element_size())
        def plain_bwd():
            a, b, _, c = nxt()
            return rn.rmsnorm_bwd(a, b, c)
        for name, call in (("rmsnorm_bwd", plain_bwd),
                           ("add_rmsnorm_bwd",
                            lambda: rn.add_rmsnorm_bwd(*nxt()))):
            split = kernel_split(torch, f"{name} {(N, d, dtype)}", call, 50)
            if split and len(split) != 1:
                raise SystemExit(f"chip_smoke: {name} {(N, d, dtype)} "
                                 f"launched {sorted(split)}, not one kernel")
            out[(name, N, d, dtype)] = split
    return out


def phase_train_timing(torch, shapes):
    """Times of the backward kernels, their plain versions and, where one
    PyTorch call computes the same function, that call's backward alone
    (F.rms_norm's; F.scaled_dot_product_attention's with enable_gqa), at
    the training path's shapes; and of the flash forward with and without
    its lse output."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn

    def rms(x, scale):
        return F.rms_norm(x, (x.shape[-1],), scale, 1e-5)

    def add_rms(x, delta, scale):
        s = x + delta
        return s, rms(s, scale)

    times = {}
    for N, d, dtype in shapes["rmsnorm_bwd"]:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        nbytes = 3 * x.numel() * x.element_size()
        nxt = _cold_copies((x, sc, dy), nbytes)
        fns = {"kernel": lambda: rn.rmsnorm_bwd(*nxt()),
               "plain": lambda: ref.rmsnorm_bwd_ref(*nxt()),
               "library": None,
               "kernel_warm": lambda: rn.rmsnorm_bwd(x, sc, dy)}
        t = _time_set(torch, "rmsnorm_bwd", (N, d, dtype), fns,
                      norm_bwd_bound(N, d, x.element_size(), False), 50)
        lib_nxt = _cold_copies((x, sc, dy), nbytes)

        def rms_inputs():
            a, b, c = lib_nxt()
            return (a, b), c
        t["library_ms"] = _backward_ms(torch, rms, rms_inputs, 50)
        log(f"[timing] rmsnorm_bwd {(N, d, dtype)}: F.rms_norm's backward "
            f"alone {t['library_ms']:.6f} ms")
        times[("rmsnorm_bwd", N, d, dtype)] = t
    for N, d, dtype in shapes["add_rmsnorm_bwd"]:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
        gs = _randn(torch, (N, d), dtype, g)
        nbytes = 4 * x.numel() * x.element_size()
        nxt = _cold_copies((x, sc, gs, dy), nbytes)
        fns = {"kernel": lambda: rn.add_rmsnorm_bwd(*nxt()),
               "plain": lambda: ref.add_rmsnorm_bwd_ref(*nxt()),
               "library": None,
               "kernel_warm": lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy)}
        t = _time_set(torch, "add_rmsnorm_bwd", (N, d, dtype), fns,
                      norm_bwd_bound(N, d, x.element_size(), True), 50)
        lib_nxt = _cold_copies((x, dy, sc, gs), nbytes)

        def lib_inputs():
            a, b, c, e = lib_nxt()
            return (a, b, c), (e, b)
        t["library_ms"] = _backward_ms(torch, add_rms, lib_inputs, 50)
        log(f"[timing] add_rmsnorm_bwd {(N, d, dtype)}: the backward alone "
            f"of x + delta then F.rms_norm {t['library_ms']:.6f} ms")
        times[("add_rmsnorm_bwd", N, d, dtype)] = t
    phase_norm_bwd_split(torch, sorted(set(shapes["rmsnorm_bwd"])
                                       | set(shapes["add_rmsnorm_bwd"])))
    sdpa = _sdpa(torch)
    for key in shapes["flash_attention_bwd"]:
        B, H, KV, S, hd, window, dtype, layout = key
        q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
        o, lse = fa._launch(q, k, v, True, window, with_lse=True)
        g = torch.Generator(device="cuda").manual_seed(S * hd + 1)
        do = _randn(torch, (B, S, H, hd), dtype, g).transpose(1, 2)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
        nxt = _cold_copies((q, k, v, o, lse, do), nbytes)
        fns = {"kernel": lambda: fa.flash_attention_bwd(
                   *nxt(), sliding_window=window),
               "plain": lambda: ref.flash_attention_bwd_ref(
                   *nxt(), sliding_window=window),
               "library": None,
               "kernel_warm": lambda: fa.flash_attention_bwd(
                   q, k, v, o, lse, do, sliding_window=window)}
        t = _time_set(torch, "flash_attention_bwd", key, fns,
                      flash_bwd_bound(*key[:7], q.element_size()), 10)
        lib_nxt = _cold_copies((q, k, v, do), nbytes)

        def sdpa_inputs():
            a, b, c, e = lib_nxt()
            return (a, b, c), e
        t["library_ms"] = _backward_ms(
            torch, lambda a, b, c: sdpa(a, b, c, window), sdpa_inputs, 10)
        log(f"[timing] flash_attention_bwd {key}: SDPA's backward alone "
            f"{t['library_ms']:.6f} ms")
        kernel_split(torch, f"flash_attention_bwd {key}",
                     lambda: fa.flash_attention_bwd(
                         q, k, v, o, lse, do, sliding_window=window), 10)
        times[("flash_attention_bwd", *key)] = t
        # the forward with and without its lse output
        nxt_f = _cold_copies((q, k, v), (2 * q.numel() + 2 * k.numel())
                             * q.element_size())
        with_lse = _graph_ms(torch, lambda: fa._launch(
            *nxt_f(), True, window, with_lse=True), 10)
        without = _graph_ms(torch, lambda: fa._launch(
            *nxt_f(), True, window), 10)
        times[("flash_attention_lse", *key)] = {"ms": with_lse,
                                                "ms_without": without}
        log(f"[timing] flash_attention forward {key}: {with_lse:.6f} ms "
            f"with lse, {without:.6f} ms without")
    return times


def path_times(times, launches_by_key):
    """One kernel's times over a path, each the mean over the shapes it ran
    at weighted by its launches there; bound_by is that of the shape with
    the most launches. launches_by_key: {key of `times`: launches}."""
    total = sum(launches_by_key.values())
    out = {k: sum(times[key][k] * n for key, n in launches_by_key.items())
           / total
           for k in ("ms", "plain_ms", "bound_ms", "eager_ms",
                     "plain_eager_ms")}
    warm = [times[key].get("warm_ms") for key in launches_by_key]
    if None not in warm:
        out["warm_ms"] = sum(w * n for w, n in zip(
            warm, launches_by_key.values())) / total
    libs = [times[key].get("library_ms") for key in launches_by_key]
    out["library_ms"] = (None if None in libs else
                         sum(times[key]["library_ms"] * n for key, n in
                             launches_by_key.items()) / total)
    out["bound_by"] = times[max(launches_by_key,
                                key=launches_by_key.get)]["bound_by"]
    return out


# ---------------------------------------------------------------------- #
def main() -> int:
    import torch
    t_script = time.perf_counter()
    card = phase_device(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside the "
                         "script: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    errs = phase_kernels(torch, CHECK_SHAPES)
    grad_errs = phase_kd_grad(torch, GRAD_SHAPES)
    nf_errs = phase_norm_flash_kernels(torch)
    bwd_errs = phase_bwd_kernels(torch)
    server, launches, shapes = phase_main_path(torch)
    baselines_s = phase_baselines(torch)
    sim_launches, sim_shapes, async_s = phase_async(torch, grad_errs)
    log(f"[main] the two new phases: baselines {baselines_s:.2f} s, async "
        f"{async_s:.2f} s, {baselines_s + async_s:.2f} s together")
    grad_main = [(C, B, V, "float32") for C, B, V in sorted(shapes)]
    grad_errs.update(phase_kd_grad(
        torch, [s for s in grad_main if s not in grad_errs]))
    # kd_loss_fwd / kd_loss_bwd, off the path now, at the path's rows
    rows_main = [(C * B, V, "float32") for C, B, V, _ in grad_main]
    errs.update(phase_kernels(torch, [s for s in rows_main if s not in errs]))
    times = phase_timing(torch, rows_main + VOCAB_SHAPES)
    grad_times = phase_grad_timing(torch, grad_main + GRAD_VOCAB)

    engine, batch, serve_launches, serve_shapes = phase_serve(torch)
    phase_serve_wrap(torch)
    serve_keys = {name: {(name, *shape): n for shape, n in by_shape.items()}
                  for name, by_shape in serve_shapes.items() if by_shape}
    for keys in serve_keys.values():
        unchecked = [k for k in keys if k not in nf_errs]
        if unchecked:
            raise SystemExit(f"chip_smoke: the serve path ran shapes phase "
                             f"3 did not check: {unchecked}")
    nf_times = phase_norm_flash_timing(
        torch, [k[1:] for k in serve_keys["rmsnorm"]],
        [k[1:] for k in serve_keys["add_rmsnorm"]],
        [k[1:] for k in serve_keys["flash_attention"]])

    phase_parity(torch)
    phase_serve_parity(torch)
    phase_profile(torch, "HAPFL round", server.run_round,
                  ("kd_grad_warp_kernel",))
    prof = phase_profile(torch, "generate",
                         lambda: engine.generate(batch, n_new=SERVE["n_new"]),
                         ("norm_kernel", "flash_wgmma_kernel"))
    report_device_gaps(torch, prof, "generate")
    prof = phase_profile(
        torch, "decode loop (graph replays)",
        lambda: decode_loop(torch, engine, SERVE["prompt"], SERVE["n_new"]),
        ("norm_kernel",))
    report_device_gaps(torch, prof, "decode loop (graph replays)")
    with torch.no_grad():
        prof = phase_profile(torch, "prefill",
                             lambda: engine._prefill(engine.params, batch),
                             ("norm_kernel", "flash_wgmma_kernel"),
                             record_shapes=True)
    check_no_layout_copies(torch, prof, engine.cfg)
    del engine, batch
    torch.cuda.empty_cache()

    state, step, train_batches, train_launches, train_shapes = phase_train(
        torch)
    train_keys = {name: {(name, *shape): n for shape, n in by_shape.items()}
                  for name, by_shape in train_shapes.items() if by_shape}
    checked = {**nf_errs, **bwd_errs,
               **{("kd_loss_grad", *k): e for k, e in grad_errs.items()}}
    unchecked = [k for keys in train_keys.values() for k in keys
                 if k not in checked]
    if unchecked:
        raise SystemExit(f"chip_smoke: the training path ran shapes phase 3 "
                         f"did not check: {unchecked}")
    phase_profile(torch, "training step",
                  lambda: step(state, train_batches[1]),
                  ("flash_bwd_dkdv", "flash_bwd_dq",
                   "flash_bwd_prep_kernel", "norm_bwd_kernel",
                   "norm_kernel", "flash_wgmma_kernel",
                   "kd_grad_row_kernel"))
    del state, step, train_batches
    torch.cuda.empty_cache()
    phase_fleet(torch)
    phase_train_parity(torch)
    phase_fleet_parity(torch)
    tr_times = phase_train_timing(
        torch, {name: [k[1:] for k in train_keys[name]]
                for name in ("rmsnorm_bwd", "add_rmsnorm_bwd",
                             "flash_attention_bwd")})
    kd_train = [k[1:] for k in train_keys["kd_loss_grad"]]
    tr_times.update(phase_grad_timing(torch, kd_train, iters=3))

    weights = {(name, C * B, V, "float32"): n
               for name in ("kd_loss_fwd", "kd_loss_bwd")
               for (C, B, V), n in shapes.items()}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
         "replaces": "src/repro/kernels/kd_loss.py:30",
         "launches": launches[name],
         "max_abs_err": max(errs[s][i] for s in rows_main),
         **path_times(times, {k: n for k, n in weights.items()
                              if k[0] == name}),
         "shapes": [[C * B, V, n] for (C, B, V), n in sorted(shapes.items())],
         "dtype": "float32",
         "path": "core.distill.mutual_losses, off the HAPFL path (timed at "
                 "its row counts)"}
        for i, name in enumerate(("kd_loss_fwd", "kd_loss_bwd"))]}
    record["kernels"].append({
        "name": "kd_loss_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
        "replaces": "src/repro/kernels/kd_loss.py:30",
        "launches": launches["kd_loss_grad"],
        "max_abs_err": max(grad_errs[s] for s in grad_main),
        **path_times(grad_times, {("kd_loss_grad", C, B, V, "float32"): n
                                  for (C, B, V), n in shapes.items()}),
        "shapes": [[C, B, V, n] for (C, B, V), n in sorted(shapes.items())],
        "dtype": "float32", "path": "HAPFL rounds",
        "sim": {"launches": sim_launches["kd_loss_grad"],
                "shapes": [[C, B, V, n]
                           for (C, B, V), n in sorted(sim_shapes.items())],
                "path": f"{ASYNC_WAVES} buffered waves, cross_size, "
                        f"topk+int8"}})
    for name, source, replaces in (
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11"),
            ("add_rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11"),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:23")):
        keys = serve_keys[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve_launches[name],
            "max_abs_err": max(nf_errs[k] for k in keys),
            **path_times(nf_times, keys),
            "shapes": [[*k[1:], n] for k, n in keys.items()],
            "dtype": "bfloat16", "path": "serve llama3.2-3b"})
    for name, replaces in (
            ("rmsnorm_bwd", "src/repro/kernels/rmsnorm.py:11"),
            ("add_rmsnorm_bwd", "src/repro/kernels/rmsnorm.py:11"),
            ("flash_attention_bwd",
             "src/repro/kernels/flash_attention.py:23")):
        keys = train_keys[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/rmsnorm.cu"
                       if "rmsnorm" in name else
                       "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": max(bwd_errs[k] for k in keys),
            **path_times(tr_times, keys),
            "shapes": [[*k[1:], n] for k, n in keys.items()],
            "dtype": "bfloat16",
            "path": f"train {TRAIN['arch']} (launches over "
                    f"{TRAIN['steps']} steps, shapes with their launches a "
                    f"step; the Pallas kernel has no backward)"})
    # the forward kernels and kd_loss_grad on the training path too
    for row in record["kernels"]:
        keys = train_keys.get(row["name"])
        if keys and row["name"] in ("rmsnorm", "add_rmsnorm",
                                    "flash_attention", "kd_loss_grad"):
            row["train"] = {
                "launches": train_launches[row["name"]],
                "shapes": [[*k[1:], n] for k, n in keys.items()]}
    kd_key = ("kd_loss_grad", *kd_train[0])
    next(r for r in record["kernels"] if r["name"] == "kd_loss_grad")[
        "train"].update({k: tr_times[kd_key][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")})
    lse = {k[1:]: v for k, v in tr_times.items()
           if k[0] == "flash_attention_lse"}
    next(r for r in record["kernels"] if r["name"] == "flash_attention")[
        "train"]["lse_ms"] = [[*k, v["ms"], v["ms_without"]]
                              for k, v in lse.items()]
    log(f"[main] chip_smoke wall {time.perf_counter() - t_script:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
