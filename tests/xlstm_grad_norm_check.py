"""xlstm-1.3b's gradient at random init, the port against the reference,
at full width (d 2048, 4 heads, V 50304) cut in depth, fp32, on the CPU,
on a batch of 4 x 16 tokens. A cut of --layers layers is --layers - 1
mLSTM blocks and then one sLSTM block: the model's first group.

Not collected by pytest (each run builds two full-width models and takes
tens of seconds and a few GB); run it by hand:

    PYTHONPATH=src python tests/xlstm_grad_norm_check.py --layers 2
    PYTHONPATH=src python tests/xlstm_grad_norm_check.py --layers 8

Both packages take one train step on the same JAX-initialised params and
batch; the script prints each step metric side by side (the grad norm
among them) and each local leaf's gradient norm and relative difference.
With --perturb it also takes the reference's gradient again on params
scaled by (1 + 2^-24 z), z standard normal: one fp32 rounding of each
parameter. How far that moves the reference's own gradient is the
tolerance the comparison can hold at that depth.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_ssm.py's TRAIN_TOL
BATCH, SEQ = 4, 16


def _name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--perturb", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(4)
    cfgs = []
    for get, dt in ((jget, jnp.float32), (tget, torch.float32)):
        cfg = dataclasses.replace(get("xlstm-1.3b"), n_layers=args.layers,
                                  slstm_every=args.layers, dtype=dt,
                                  remat=False, scan_layers=False)
        cfgs += [cfg, dataclasses.replace(cfg.lite(), dtype=dt, remat=False,
                                          scan_layers=False)]
    jparams = jax.device_get(jstep.make_train_state(
        jax.random.PRNGKey(0), cfgs[0], cfgs[1])["params"])
    rng = np.random.default_rng(15)
    batch = {k: rng.integers(0, cfgs[0].vocab_size,
                             (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jt, tt = jstep.TrainStepConfig(), tstep.TrainStepConfig()

    _, jm = jax.jit(jstep.make_hapfl_train_step(cfgs[0], cfgs[1], jt))(
        {"params": jparams, "opt": jopt.adamw(jt.lr).init(jparams)}, jb)
    params = params_from_numpy(jparams, device="cpu")
    _, tm = tstep.make_hapfl_train_step(cfgs[2], cfgs[3], tt)(
        {"params": params, "opt": topt.adamw(tt.lr).init(params)}, tb)
    print(f"xlstm-1.3b, {args.layers} layers (sLSTM last), d "
          f"{cfgs[0].d_model}, V {cfgs[0].vocab_size}, batch {BATCH} x {SEQ}, "
          f"fp32")
    for k in sorted(jm):
        a, b = float(jm[k]), float(tm[k])
        close = bool(np.isclose(b, a, **TOL))
        print(f"  {k:16s} reference {a!r:24} port {b!r:24} rel "
              f"{abs(b - a) / max(abs(a), 1e-30):.3e} "
              f"{'within' if close else 'outside'} atol 1e-5 rtol 1e-4")

    grad = jax.jit(jax.grad(
        lambda p_, b_: jstep._losses(p_, cfgs[0], cfgs[1], jt, b_)[0]))
    jg = jax.device_get(grad(jparams, jb))
    _, tg = tstep.loss_and_grads(params_from_numpy(jparams, device="cpu"),
                                 cfgs[2], cfgs[3], tt, tb)
    pg = None
    if args.perturb:
        r2 = np.random.default_rng(1)
        jp2 = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) * (1 + 2.0 ** -24 * r2.standard_normal(
                np.shape(a)))).astype(np.asarray(a).dtype), jparams)
        pg = jax.device_get(grad(jp2, jb))
    print("  local leaf: |g| reference, rel|port - reference|"
          + (", rel|perturbed reference - reference|" if pg else ""))
    for path, a in jax.tree_util.tree_flatten_with_path(jg)[0]:
        if not _name(path).startswith("local/"):
            continue
        a = np.asarray(a, np.float64)
        na = max(float(np.linalg.norm(a)), 1e-30)
        line = (f"  {_name(path):32s} {na:.6e} "
                f"{np.linalg.norm(_at(tg, path).double().numpy() - a) / na:.3e}")
        if pg is not None:
            line += f" {np.linalg.norm(np.asarray(_at(pg, path)) - a) / na:.3e}"
        print(line)


if __name__ == "__main__":
    main()
