"""Job "serve": offline batched greedy generation through
`repro_torch.serve.ServeEngine.generate`, one client submitting call after
call back to back; each call carries `batch` requests of `prompt` positions
and `new_tokens` greedy tokens.

Set-up makes the weights from the seed, builds the engine and runs calls 0
and 1: call 0 warms the prefill and captures the decode step's CUDA graph
at this batch size, and call 1 still mallocs device memory (13 blocks on
qwen3-moe), which the caching allocator then reuses. The window runs calls
2, 3, ... A request's time runs from the issue of its call to its tokens on
the host.

The engine returns the n_new decode argmaxes; the argmax of the prompt's
last position, which it feeds to the first decode step, it keeps. So the
job wraps the engine's prefill call to keep that argmax (one argmax kernel
a call) and, in the traced run, to time the prefill; the wrapper reaches a
private name of the engine, and a run fails loudly if `generate` stops
calling it. `judge` replays one call of the window, drawn from the seed,
through the reference and reads each served token's gap below the
reference's best logit: their mean, and the widest of the requests' means.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

from portbench import harness
from portbench.reference import model as M
from portbench.reference.serve import gaps, replay
from portbench.traffic import Traffic
from portbench.weights import make_group, program_tree

WARM_CALLS = 2


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.spec = M.from_config(ctx.config)
        tr = ctx.cell["traffic"]
        self.B, self.P, self.n = tr["batch"], tr["prompt"], tr["new_tokens"]
        self.max_len = tr["max_len"]

    def setup(self) -> None:
        ctx, torch = self.ctx, self.ctx.torch
        from repro_torch.serve import ServeEngine
        cfg = harness.program_config(self.spec, ctx.config["name"])
        params = program_tree(self.spec, ctx.seed, "model", ctx.device)
        harness.mark(ctx, "weights")
        table = (params["io"]["embed"].clone() if self.spec.embeddings_in
                 else None)
        self.traffic = Traffic(ctx.cell["traffic"], self.spec, ctx.seed,
                               ctx.device, table)
        self.engine = ServeEngine(cfg, params, max_len=self.max_len,
                                  device=ctx.device)
        inner = self.engine._prefill
        self.first: List = []           # each call's prompt argmax (B,)
        self.prefill_s: List[float] = []
        self.time_prefill = False

        def prefill(p, batch):
            if self.time_prefill:
                harness.sync(torch)
                t0 = time.perf_counter()
            logits, cache = inner(p, batch)
            self.first.append(logits[:, -1].argmax(-1))
            if self.time_prefill:
                harness.sync(torch)
                self.prefill_s.append(time.perf_counter() - t0)
            return logits, cache
        self.engine._prefill = prefill
        self.calls: Dict[int, dict] = {}
        for c in range(WARM_CALLS):
            self._call(c)
            harness.mark(ctx, f"call {c}")

    def _call(self, c: int) -> float:
        prompts = self.traffic.prompts(c)
        t0 = time.perf_counter()
        n_first = len(self.first)
        toks = self.engine.generate(prompts, n_new=self.n)
        lat = time.perf_counter() - t0
        if len(self.first) != n_first + 1:
            raise RuntimeError(
                "portbench: generate no longer calls ServeEngine._prefill "
                "once a call, which keeps the prompt's argmax")
        self.calls[c] = {"tokens": toks, "first": self.first[-1],
                         "latency": lat}
        return lat

    def window(self, seconds: float) -> dict:
        torch = self.ctx.torch
        c = max(self.calls) + 1
        lats, alloc = [], [harness.alloc_counts(torch)]
        t0 = time.perf_counter()
        while True:
            lats.append(self._call(c))
            alloc.append(harness.alloc_counts(torch))
            c += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.window_calls = sorted(self.calls)[WARM_CALLS:]
        return {"calls": len(lats), "latencies": lats, "window_s": elapsed,
                "failed": 0, "alloc": alloc}

    def traced(self, span_calls: int, profile_calls: int) -> dict:
        torch = self.ctx.torch
        c = max(self.calls) + 1
        self.time_prefill = True
        call_s = [self._call(c + i) for i in range(span_calls)]
        self.time_prefill = False
        c += span_calls

        def run(first, n):
            for i in range(first, first + n):
                with torch.profiler.record_function("portbench.call"):
                    self._call(i)
        prof = harness.profile(torch, lambda: run(c, profile_calls))
        prof["gaps"] = harness.profile(
            torch, lambda: run(c + profile_calls, 1), True)["gaps"]
        self.window_calls = sorted(self.calls)[WARM_CALLS:]
        return {"calls": span_calls + profile_calls + 1, "failed": 0,
                "record": {"job": "serve", "call_s": call_s,
                           "prefill_s": list(self.prefill_s),
                           "profile": prof, "profile_calls": profile_calls,
                           "spec": self.spec, "batch": self.B,
                           "prompt": self.P, "n_new": self.n}}

    def e2e(self, w: dict, setup_s: float) -> Dict[str, float]:
        per_request = [lat for lat in w["latencies"] for _ in range(self.B)]
        return {"serve_tokens_per_s": w["calls"] * self.B * self.n
                / w["window_s"],
                "request_s_p95": harness.percentile(per_request, 95),
                "setup_s": setup_s}

    def attempted(self, w: dict) -> int:
        return w["calls"] * self.B

    def free(self) -> None:
        self.engine = None
        for c in self.calls.values():
            c["first"] = c["first"].cpu()
        self.first = []
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.ctx.torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    def sample(self) -> int:
        """The window call the judgement replays, drawn from the seed."""
        return random.Random(self.ctx.seed).choice(self.window_calls)

    def served(self, c: int):
        torch = self.ctx.torch
        call = self.calls[c]
        toks = torch.as_tensor(call["tokens"], device=self.ctx.device)
        return torch.cat([call["first"].to(self.ctx.device)[:, None],
                          toks], 1)

    def reference(self, c: int, precision: str = "fp32", stats=None):
        ctx = self.ctx
        table = (make_group(self.spec, ctx.seed, "model", "io",
                            ctx.device)["embed"]
                 if self.spec.embeddings_in else None)
        traffic = Traffic(ctx.cell["traffic"], self.spec, ctx.seed,
                          ctx.device, table)
        served = self.served(c)
        dec = (traffic.decode_positions(self.B, self.P, self.n)
               if self.spec.mrope else None)
        return replay(self.spec, ctx.seed, "model", traffic.prompts(c),
                      served[:, :-1], dec, ctx.device, precision, stats)

    @staticmethod
    def numbers(ref_logits, tokens) -> dict:
        """gap_mean: the mean gap of the served tokens below the
        reference's best logit; request_gap_max: the widest of the
        requests' mean gaps; token_gap: the widest gap of one token; flips:
        the share of tokens that are not the reference's argmax."""
        g = gaps(ref_logits, tokens)
        return {"gap_mean": float(g.mean()),
                "request_gap_max": float(g.mean(1).max()),
                "token_gap": float(g.max()),
                "flips": float((g > 0).float().mean())}

    def judge(self, checks: harness.Checks) -> dict:
        c = self.sample()
        stats: dict = {}
        logits = self.reference(c, stats=stats)
        nums = self.numbers(logits, self.served(c))
        for k, lim in self.ctx.cell["limits"].items():
            checks.add(k, nums[k], lim)
        out = {"call": c, **nums}
        if "experts" in stats:
            per = self.n + 1          # the prompt's group, then n steps
            dec = [e for i, e in enumerate(stats["experts"]) if i % per]
            out["experts_per_decode_step"] = sum(dec) / len(dec)
        return out


def make(ctx):
    return Job(ctx)
