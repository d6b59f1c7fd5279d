"""Job "train": one HAPFL client's local training at transformer widths,
`repro_torch.train.step.make_hapfl_train_step` on the local model and its
LiteModel, closed loop: the next step starts when the previous one has
returned its loss to the host, as a training loop logs it.

Set-up makes both models' weights from the seed, builds the step and its
AdamW state once, and drives that same object through its first
`CHECK_STEPS` steps, on the window's own feed (batches 0, 1, 2): the first
step warms every shape. Those steps are what `judge` holds against the
reference: each step's loss, the first gradient as AdamW received it (its
first moment after one step over 1 - b1) and each leaf's change after the
third step. The window then runs batches 3, 4, ... on the same object.

The step's settings are the cell's ("step"); an MoE model's load-balance
coefficient is its configuration's `router_aux_loss_coef`, and its z-loss
coefficient its `router_z_loss_coef` (0 where the configuration states
none), so the step trains the model as its configuration states.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict

from portbench import harness
from portbench.reference import model as M
from portbench.reference.train import follow, leaf_name
from portbench.traffic import Traffic
from portbench.weights import make_group, program_leaf, program_tree

CHECK_STEPS = 3
#: the step's four loss terms, as the program's metrics name them
TERMS = ("ce_local", "ce_lite", "kl_local_lite", "kl_lite_local")
B1 = 0.9     # AdamW's first-moment decay, the program's default


def tree_norms(torch, tree) -> Dict[str, float]:
    """{"a/b/c": fp32 norm} of every tensor leaf of a nested dict."""
    names, vals = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            names.append("/".join(path))
            vals.append(t.float().norm())
    walk(tree, ())
    return dict(zip(names, torch.stack(vals).tolist()))


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        cj, cell = ctx.config, ctx.cell
        self.specs = [("local", M.from_config(cj)),
                      ("lite", M.from_config(cj, lite=True))]
        self.hp = dict(cell["step"],
                       moe_aux_coef=cj.get("router_aux_loss_coef", 0.0),
                       z_loss_coef=cj.get("router_z_loss_coef", 0.0))
        tr = cell["traffic"]
        self.B, self.S = tr["batch"], tr["seq"]
        self.tokens_per_step = self.B * self.S

    # ------------------------------------------------------------------ #
    def setup(self) -> None:
        ctx, torch, dev = self.ctx, self.ctx.torch, self.ctx.device
        from repro_torch.optim import adamw
        from repro_torch.train.step import (TrainStepConfig,
                                            make_hapfl_train_step)
        hp = self.hp
        sl = self.specs[0][1]
        cfgs = [harness.program_config(s, f"{ctx.config['name']}-{n}",
                                       hp["remat"]) for n, s in self.specs]
        tcfg = TrainStepConfig(
            lambdas=tuple(hp["lambdas"]), lr=hp["lr"],
            weight_decay=hp.get("weight_decay", 0.0),
            grad_clip=hp["grad_clip"],
            moe_aux_coef=hp["moe_aux_coef"], z_loss_coef=hp["z_loss_coef"])
        params = {n: program_tree(s, ctx.seed, n, dev) for n, s in self.specs}
        opt = adamw(tcfg.lr, weight_decay=tcfg.weight_decay)
        self.state = {"params": params, "opt": opt.init(params)}
        harness.mark(ctx, "weights and AdamW state")
        self.step = make_hapfl_train_step(cfgs[0], cfgs[1], tcfg)
        table = (params["local"]["io"]["embed"].clone()
                 if sl.embeddings_in else None)
        self.traffic = Traffic(ctx.cell["traffic"], sl, ctx.seed, dev, table)
        self.losses, self.terms = [], []
        for i in range(CHECK_STEPS):
            self.state, m = self.step(self.state, self.traffic.train_batch(i))
            self.losses.append(float(m["loss"]))
            self.terms.append([float(m[t]) for t in TERMS])
            harness.mark(ctx, f"step {i + 1}")
            if i == 0:
                self.grad = {n: v / (1 - B1) for n, v in tree_norms(
                    torch, self.state["opt"]["m"]).items()}
        self.change = self._change()
        harness.mark(ctx, "change read")
        self.next_batch = CHECK_STEPS

    def _change(self) -> Dict[str, float]:
        torch, ctx = self.ctx.torch, self.ctx
        sq: Dict[str, "torch.Tensor"] = {}
        for n, spec in self.specs:
            tree = self.state["params"][n]
            for g in ["io"] + [f"layer{l}" for l in range(spec.layers)]:
                start = make_group(spec, ctx.seed, n, g, ctx.device)
                for name, t in start.items():
                    key = leaf_name(n, g, name)
                    d = (program_leaf(tree, g, name).float()
                         - t.float()).square().sum()
                    sq[key] = sq[key] + d if key in sq else d
                del start
        keys = list(sq)
        vals = torch.stack([sq[k] for k in keys]).sqrt().tolist()
        return dict(zip(keys, vals))

    def _one(self) -> float:
        batch = self.traffic.train_batch(self.next_batch)
        self.next_batch += 1
        self.state, m = self.step(self.state, batch)
        return float(m["loss"])

    # ------------------------------------------------------------------ #
    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed: {"steps", "failed",
        "window_s"}."""
        torch = self.ctx.torch
        steps = failed = 0
        ends, alloc = [], [harness.alloc_counts(torch)]
        t0 = time.perf_counter()
        while True:
            loss = self._one()
            alloc.append(harness.alloc_counts(torch))
            steps += 1
            failed += not math.isfinite(loss)
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                break
        return {"steps": steps, "failed": failed, "window_s": elapsed,
                "latencies": [b - a for a, b in zip([0.0] + ends, ends)],
                "alloc": alloc}

    def traced(self, span_steps: int, profile_steps: int) -> dict:
        """`span_steps` steps timed by the host around the step and around
        its loss_and_grads call (each synchronised), then `profile_steps`
        under torch.profiler (device events), then one more with the
        host's operations traced too, which labels the idle gaps."""
        torch = self.ctx.torch
        from repro_torch.train import step as step_mod
        inner = step_mod.loss_and_grads
        grads_s = []

        def timed(*a, **k):
            harness.sync(torch)
            t0 = time.perf_counter()
            out = inner(*a, **k)
            harness.sync(torch)
            grads_s.append(time.perf_counter() - t0)
            return out

        step_s, failed = [], 0
        step_mod.loss_and_grads = timed
        try:
            for _ in range(span_steps):
                harness.sync(torch)
                t0 = time.perf_counter()
                failed += not math.isfinite(self._one())
                step_s.append(time.perf_counter() - t0)
        finally:
            step_mod.loss_and_grads = inner
        if len(grads_s) != span_steps:
            raise RuntimeError(
                "portbench: the step no longer calls repro_torch.train.step."
                "loss_and_grads once a step, which grads_ms.train times")

        def run(n):
            for _ in range(n):
                with torch.profiler.record_function("portbench.step"):
                    self._one()
        prof = harness.profile(torch, lambda: run(profile_steps))
        prof["gaps"] = harness.profile(torch, lambda: run(1), True)["gaps"]
        return {"steps": span_steps + profile_steps + 1, "failed": failed,
                "record": {"job": "train", "step_s": step_s,
                           "grads_s": grads_s, "profile": prof,
                           "profile_steps": profile_steps,
                           "specs": [s for _, s in self.specs],
                           "batch": self.B, "seq": self.S,
                           "remat": self.hp["remat"]}}

    def e2e(self, w: dict, setup_s: float) -> Dict[str, float]:
        return {"train_tokens_per_s": w["steps"] * self.tokens_per_step
                / w["window_s"], "setup_s": setup_s}

    def attempted(self, w: dict) -> int:
        return w["steps"]

    def free(self) -> None:
        self.state = self.step = self.traffic = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.ctx.torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    def reference(self, precision: str = "fp32", half_batch: bool = False,
                  hp: dict = None):
        ctx = self.ctx
        sl = self.specs[0][1]
        table = (make_group(sl, ctx.seed, "local", "io", ctx.device)["embed"]
                 if sl.embeddings_in else None)
        traffic = Traffic(ctx.cell["traffic"], sl, ctx.seed, ctx.device,
                          table)
        batches = [traffic.train_batch(k) for k in range(CHECK_STEPS)]
        del traffic, table
        return follow(self.specs, ctx.seed, hp or self.hp, batches,
                      ctx.device, precision, half_batch)

    @staticmethod
    def numbers(prog: dict, ref: dict, detail: bool = False) -> dict:
        """The compared numbers of a run `prog` ({"losses", "grad",
        "change"}) against the reference's; with `detail`, also each
        step's loss gap and the worst leaves' names."""
        steps = [abs(a - b) / abs(b) for a, b in
                 zip(prog["losses"], ref["losses"])]
        grad, g_at = harness.worst_leaf_gap(prog["grad"], ref["grad"])
        g = sorted(ref["grad"].values())
        floor = 1e-3 * g[len(g) // 2]
        moved = [k for k, v in ref["grad"].items() if v >= floor]
        change, c_at = harness.worst_leaf_gap(prog["change"], ref["change"],
                                              moved)
        terms1 = max(abs(a - b) / abs(b) for a, b in
                     zip(prog["terms"][0], ref["terms"][0]))
        out = {"terms1_rel": terms1, "loss1_rel": steps[0],
               "loss_rel": max(steps),
               "grad_leaf": grad, "change_leaf": change}
        if detail:
            out.update(
                grad_median=harness.median(harness.leaf_gaps(
                    prog["grad"], ref["grad"]).values()),
                change_median=harness.median(harness.leaf_gaps(
                    prog["change"], ref["change"], moved).values()),
                loss_steps=steps, grad_at=g_at, change_at=c_at,
                       left_out=sorted(set(ref["grad"]) - set(moved)))
        return out

    def readings(self) -> dict:
        """What set-up read from the program's first steps."""
        return {"losses": self.losses, "terms": self.terms,
                "grad": self.grad, "change": self.change}

    def judge(self, checks: harness.Checks) -> dict:
        ref = self.reference()
        nums = self.numbers(self.readings(), ref)
        for k, lim in self.ctx.cell["limits"].items():
            checks.add(k, nums[k], lim)
        return {"ref": ref, "numbers": nums}


def make(ctx):
    return Job(ctx)
