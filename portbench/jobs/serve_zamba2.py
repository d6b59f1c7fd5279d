"""Job "serve_zamba2": the "serve" job (`jobs/serve.py`, the same traffic,
windows, record and judgement) on Zamba2 as published, through
`repro_torch.serve.ServeEngine.generate` with `return_first=True`, which
gives the prompt's argmax beside the n_new decode argmaxes: the job reaches
no private name of the program.

The weights and the judgement's forward are `reference/zamba2.py`'s; the
program's model configuration (family "zamba2") is made here from its Spec.
The traced run reads each of its span calls' prefill from the call itself:
the call runs under the program's phase tracer
(`repro_torch.obs.trace.enable`), and its one `serve.prefill` span gives
the prefill's time, on the device clock (on the host's off CUDA), beside
the call's time on the host; the tracer starts after a synchronise, so the
device is idle when the prefill is issued. Its record adds, for this cell's
per-layer metrics
(`metrics/*hybrid*`, `ssd_scan_ms.serve`, `shared_block_ms.serve`,
`roofline.flash_attention.serve`), "model": "zamba2" and the calls' count
of shared-block calls and Mamba2 layers.

`served_zero_state(c)` serves call c's prompts again with the engine's
`carry_prompt_state` off, so that its decode starts from a zeroed
recurrent state: the planted fault of `control_state.py`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

from portbench import harness
from portbench.reference import zamba2 as Z
from portbench.traffic import Traffic

_serve = harness.load_module("jobs", "serve")
Base, WARM_CALLS = _serve.Job, _serve.WARM_CALLS


def program_config(spec: Z.Spec, name: str):
    """The program's `ModelConfig` of a zamba2 Spec, family "zamba2"."""
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.ssm import MAMBA_HEAD_DIM
    if (spec.mamba_head_dim, spec.expand, spec.eps) != (MAMBA_HEAD_DIM, 2,
                                                         1e-5):
        raise ValueError("the program's Mamba2 takes heads of "
                         f"{MAMBA_HEAD_DIM}, expand 2 and eps 1e-5")
    return ModelConfig(
        name=name, family="zamba2", n_layers=spec.layers, d_model=spec.d,
        n_heads=spec.heads, n_kv_heads=spec.kv_heads, head_dim=spec.head_dim,
        d_ff=spec.ff, vocab_size=spec.vocab, ssm_state=spec.d_state,
        ssm_conv=spec.conv, rope_theta=spec.rope_theta, norm="rmsnorm",
        act="gelu", tie_embeddings=spec.tie, dtype=getattr(torch, spec.dtype),
        remat=False, mamba_groups=spec.groups, shared_blocks=spec.blocks,
        hybrid_layer_ids=spec.hybrid,
        shared_mlp_adapter_rank=spec.adapter_rank, dt_min=spec.dt_min,
        carry_prompt_state=True)


class Job(Base):
    def __init__(self, ctx):
        self.ctx = ctx
        self.spec = Z.from_config(ctx.config)
        tr = ctx.cell["traffic"]
        self.B, self.P, self.n = tr["batch"], tr["prompt"], tr["new_tokens"]
        self.max_len = tr["max_len"]

    def setup(self) -> None:
        ctx = self.ctx
        from repro_torch.serve import ServeEngine
        self.cfg = program_config(self.spec, ctx.config["name"])
        self.params = Z.program_tree(self.spec, ctx.seed, "model", ctx.device)
        harness.mark(ctx, "weights")
        self.traffic = Traffic(ctx.cell["traffic"], self.spec, ctx.seed,
                               ctx.device)
        self.engine = ServeEngine(self.cfg, self.params,
                                  max_len=self.max_len, device=ctx.device)
        self.calls: Dict[int, dict] = {}
        for c in range(WARM_CALLS):
            self._call(c)
            harness.mark(ctx, f"call {c}")

    def _call(self, c: int) -> float:
        prompts = self.traffic.prompts(c)
        t0 = time.perf_counter()
        toks, first = self.engine.generate(prompts, n_new=self.n,
                                           return_first=True)
        lat = time.perf_counter() - t0
        self.calls[c] = {"tokens": toks, "first": self.ctx.torch.as_tensor(
            first), "latency": lat}
        return lat

    def _timed_call(self, c: int):
        """Call c under the program's phase tracer: (the call's seconds,
        its prefill's seconds from its `serve.prefill` span)."""
        from repro_torch.obs import trace
        tracer = trace.enable(trace.Tracer())
        try:
            lat = self._call(c)
        finally:
            trace.disable()
        spans = [trace.resolve(p) for p in tracer.phases
                 if p.name == "serve.prefill"]
        if len(spans) != 1:
            raise RuntimeError(f"portbench: a generate call recorded "
                               f"{len(spans)} serve.prefill spans, not 1")
        (t0, t1), dev = spans[0]["host"], spans[0]["device"]
        return lat, (t1 - t0 if dev is None else (dev[1] - dev[0]) / 1e3)

    def traced(self, span_calls: int, profile_calls: int) -> dict:
        torch = self.ctx.torch
        c = max(self.calls) + 1
        prefill_s, call_s = [], []
        for i in range(c, c + span_calls):
            lat, pre = self._timed_call(i)
            call_s.append(lat)
            prefill_s.append(pre)
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
                "record": {"job": "serve", "model": "zamba2",
                           "call_s": call_s, "prefill_s": prefill_s,
                           "profile": prof, "profile_calls": profile_calls,
                           "spec": self.spec, "batch": self.B,
                           "prompt": self.P, "n_new": self.n,
                           "shared_calls": len(self.spec.hybrid),
                           "mamba_layers": self.spec.layers}}

    def free(self) -> None:
        self.params = None
        super().free()

    # ------------------------------------------------------------------ #
    def served_zero_state(self, c: int):
        """Call c served again with the prompt's recurrent state dropped:
        the decode starts from zeroed SSM and conv states (the prompt's KV
        is kept). (B, n + 1) tokens on the device, as `served` gives."""
        torch = self.ctx.torch
        eng = self.engine
        eng.cfg = dataclasses.replace(self.cfg, carry_prompt_state=False)
        try:
            toks, first = eng.generate(self.traffic.prompts(c), n_new=self.n,
                                       return_first=True)
        finally:
            eng.cfg = self.cfg
        dev = self.ctx.device
        return torch.cat([torch.as_tensor(first, device=dev)[:, None],
                          torch.as_tensor(toks, device=dev)], 1)

    def reference(self, c: int, precision: str = "fp32", stats=None):
        ctx = self.ctx
        traffic = Traffic(ctx.cell["traffic"], self.spec, ctx.seed,
                          ctx.device)
        served = self.served(c)
        return Z.replay(self.spec, ctx.seed, "model",
                        traffic.prompts(c)["tokens"], served[:, :-1],
                        precision)


def make(ctx):
    return Job(ctx)
