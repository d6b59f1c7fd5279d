"""The mesh-sharded path of the port on the CPU, with gloo: launch/mesh.py,
launch/axes.py, kernels/sharded.py, fl/sharded.py, the length-sharded
flash decode and the grouped MoE dispatch, against the reference.

In process, a one-rank group (torch.distributed on an in-memory store) runs
the sharded engine at world 1, where it is the batched engine's program:
bitwise equal. Worlds 2 and 4 are one `torch.multiprocessing` spawn each;
every rank writes its results to an npz file and the tests read them. One
JAX subprocess with 4 forced host devices gives the reference's values at
G > 1 and model > 1: `apply_moe` under `use_axis_rules(make_debug_mesh(2))`
and `(4)`, and `flash_decode_shardmap` on a (1, 4) mesh.

Tolerances: cohorts across ranks at atol 1e-5 / rtol 1e-4 (the reference's
MESH_PARITY_SNIPPET: a rank's batched products run on fewer clients); the
sharded kernels bitwise (row-independent); the decode at 1e-5 against
world 1 in fp32 (the ranks' softmax partials are summed in another order);
MoE routes, `dest` and `keep` bitwise, y, the aux losses and the caches at
1e-5.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.fl import (BatchedClientEngine, FLEnvironment,  # noqa: E402
                            FLSimConfig, HAPFLServer, ShardedClientEngine)
from repro_torch.fl.sharded import pad_to_mesh  # noqa: E402
from repro_torch.kernels.ops import (flash_attention_op,  # noqa: E402
                                     kd_loss_op, rmsnorm_op)
from repro_torch.kernels.sharded import (sharded_flash_attention,  # noqa: E402
                                         sharded_kd_loss, sharded_rmsnorm)
from repro_torch.launch import axes as taxes  # noqa: E402
from repro_torch.launch.mesh import (backend_for, make_debug_mesh,  # noqa: E402
                                     production_mesh_shape)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = FLSimConfig(dataset="mnist", n_train=400, n_test=100,
                  batches_per_epoch=1, default_epochs=2,
                  n_clients=6, k_per_round=4,
                  size_names=("small", "large"))
COHORT = ([0, 1, 2, 3], ["small", "small", "large", "large"], [1, 3, 2, 1])
RAGGED = ([1, 4], ["small", "small"], [1, 3])
# four clients of batch 32 in one (size, batch, 4-step) group: C_p = 4, so
# every rank at world 2 and 4 trains real clients, some on masked steps
ONE_GROUP = ([0, 1, 2, 4], ["small"] * 4, [3, 4, 4, 3])
# the flash-decode function's inputs: KV 2 heads under a model axis of 4,
# the slot in the third of four length slices
FD = {"B": 2, "H": 4, "KV": 2, "hd": 16, "L": 32, "slot": 20, "valid": 21}
MOE_SHAPE = (2, 64)            # (B, S): N = 128 tokens, G in (1, 2, 4)
MOE_CF = 0.5                   # so that every G drops pairs


class _Mesh:
    """A stand-in with the reference mesh's `axis_names` and `shape`."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def _close(a, b, atol=1e-5, rtol=1e-4):
    return all(torch.allclose(x, y, atol=atol, rtol=rtol)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _flat(trees):
    return np.concatenate([t.detach().numpy().ravel()
                           for t in tree_leaves(trees)])


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test, torn down after it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------------ #
# pure functions against the reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("shards", range(1, 9))
@pytest.mark.parametrize("n", range(1, 34))
def test_pad_to_mesh_matches_reference(n, shards):
    from repro.fl.sharded import pad_to_mesh as ref_pad
    assert pad_to_mesh(n, shards) == ref_pad(n, shards)


@pytest.mark.parametrize("names,shape,mesh", [
    (("batch", None, "heads", None), (8, 16, 32, 64),
     {"pod": 2, "data": 4, "model": 4}),
    (("batch", "seq", "embed"), (6, 16, 64), {"data": 4, "model": 2}),
    (("batch", "cache_seq", "kv_heads", None), (4, 128, 2, 64),
     {"data": 2, "model": 4}),
    (("experts", "embed", "ff"), (8, 64, 3), {"data": 2, "model": 4}),
    (("vocab", "fsdp"), (49155, 4096), {"pod": 2, "data": 16, "model": 16}),
    (("batch", "heads"), None, {"data": 1, "model": 8}),
])
def test_logical_to_pspec_matches_reference(names, shape, mesh):
    from repro.launch import axes as jaxes
    m = _Mesh(**mesh)
    want = jaxes.logical_to_pspec(names, m, jaxes.DEFAULT_RULES, shape=shape)
    got = taxes.logical_to_pspec(names, m, taxes.DEFAULT_RULES, shape=shape)
    # a PartitionSpec keeps a one-axis entry as the bare name
    assert got == tuple((w,) if isinstance(w, str) else w for w in want)
    x = torch.zeros(len(names) * (1,))
    assert taxes.shard(x, *names) is x         # eager: no constraint


def test_mesh_shapes_and_backend_rule():
    assert production_mesh_shape(16) == ((2, 8), ("data", "model"))
    assert production_mesh_shape(32, multi_pod=True) == (
        (2, 2, 8), ("pod", "data", "model"))
    for world, pod in ((4, False), (12, False), (8, True), (24, True)):
        with pytest.raises(ValueError):
            production_mesh_shape(world, pod)
    assert backend_for("cuda", 1, 1) == "nccl"
    assert backend_for("cuda", 4, 8) == "nccl"
    assert backend_for("cuda", 2, 1) == "gloo"      # ranks share a card
    assert backend_for("cpu", 1, 0) == "gloo"


def test_moe_groups_rule():
    cfg = tget_config("qwen3-moe-30b-a3b").smoke()
    assert tmoe._moe_groups(cfg, 64) == 1
    with taxes.use_axis_rules(_Mesh(pod=2, data=4, model=2)):
        assert tmoe._moe_groups(cfg, 64) == 8
        assert tmoe._moe_groups(cfg, 12) == 4       # 8 halved to divide 12
        assert tmoe._moe_groups(cfg, 6) == 2
    assert taxes.current_mesh() is None


# ------------------------------------------------------------------ #
# world 1, in process
# ------------------------------------------------------------------ #
def test_debug_mesh_axes(one_rank):
    mesh = make_debug_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert dist.get_backend() == "gloo"
    with pytest.raises(ValueError):
        make_debug_mesh(2, device="cpu")


def test_sharded_matches_batched_cohort(one_rank):
    """At one shard the sharded engine runs the batched engine's program on
    the same clients: bitwise."""
    a = BatchedClientEngine(FLEnvironment(CFG), device="cpu")
    b = ShardedClientEngine(FLEnvironment(CFG), device="cpu")
    srv = HAPFLServer(FLEnvironment(CFG), seed=0, device="cpu")
    pa = a.train_cohort(*COHORT, srv.global_by_size, srv.lite_params)
    pb = b.train_cohort(*COHORT, srv.global_by_size, srv.lite_params)
    assert b.n_shards == 1 and _equal(pa, pb)


def test_sharded_pad_invariance(one_rank):
    eng_a = ShardedClientEngine(FLEnvironment(CFG), device="cpu")
    eng_b = ShardedClientEngine(FLEnvironment(CFG), device="cpu")
    srv = HAPFLServer(FLEnvironment(CFG), seed=0, device="cpu")
    padded = eng_a.train_cohort(*RAGGED, srv.global_by_size,
                                srv.lite_params, pad_pow2=True)
    exact = eng_b.train_cohort(*RAGGED, srv.global_by_size,
                               srv.lite_params, pad_pow2=False)
    assert _equal(padded, exact)


def test_server_round_parity_sharded_vs_batched(one_rank):
    a = HAPFLServer(FLEnvironment(CFG), seed=3, engine="batched",
                    device="cpu")
    b = HAPFLServer(FLEnvironment(CFG), seed=3, engine="sharded",
                    device="cpu")
    rec_a, rec_b = a.run_round(), b.run_round()
    assert rec_a.sizes == rec_b.sizes
    assert rec_a.intensities == rec_b.intensities
    assert _equal(a.lite_params, b.lite_params)
    assert _equal(a.global_by_size, b.global_by_size)
    assert b.mesh is b.batched_engine.mesh


def test_auto_mesh_selects_sharded_engine(one_rank):
    srv = HAPFLServer(FLEnvironment(CFG), mesh=make_debug_mesh(device="cpu"),
                      device="cpu")
    assert srv.engine == "sharded"
    assert isinstance(srv.batched_engine, ShardedClientEngine)
    with pytest.raises(ValueError):
        HAPFLServer(FLEnvironment(CFG), mesh=srv.mesh, engine="batched",
                    device="cpu")


def test_sharded_engine_rejects_missing_axis():
    with pytest.raises(ValueError, match="data"):
        ShardedClientEngine(FLEnvironment(CFG), mesh=_Mesh(replica=1),
                            device="cpu")


def test_sharded_kernels_reject_indivisible_rows():
    x = torch.zeros(6, 8)
    mesh = _Mesh(data=4)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_kd_loss(x, x, torch.zeros(6, dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_rmsnorm(x, torch.ones(8), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_flash_attention(*[torch.zeros(6, 1, 4, 8)] * 3, mesh)


def test_decode_cache_under_a_length_sharded_mesh():
    """Under a mesh whose model axis does not divide n_kv_heads, the KV
    cache is the rank's (B / dp, L / model) slice, and L must divide; the
    serving engine refuses the sharded decode."""
    from repro_torch.models.api import make_decode_cache
    from repro_torch.serve import ServeEngine
    cfg = tget_config("qwen2-vl-2b").smoke()            # 2 KV heads
    with taxes.use_axis_rules(_Mesh(data=2, model=4)):
        cache = make_decode_cache(cfg, 4, 32, "cpu")
        assert tuple(cache["blocks"]["k"].shape) == (
            cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
        with pytest.raises(ValueError, match="divide"):
            make_decode_cache(cfg, 4, 30, "cpu")
        with pytest.raises(RuntimeError, match="decode_step"):
            ServeEngine(cfg, {}, max_len=32, device="cpu").decode_step_for(4)
    with taxes.use_axis_rules(_Mesh(data=2, model=2)):   # 2 % 2 == 0
        assert tuple(make_decode_cache(cfg, 4, 30, "cpu")["blocks"][
            "k"].shape)[1:3] == (4, 30)


def test_fill_decode_cache_then_decode_matches_forward():
    """prefill, fill_decode_cache, then decode steps give the full
    forward's logits (no mesh): the ring buffer holds the prompt."""
    from repro_torch.models import api
    cfg = dataclasses.replace(tget_config("llama3.2-3b").smoke(),
                              dtype=torch.float32)
    params = api.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full, _ = api.forward(params, cfg, {"tokens": tok})
        _, pre = api.prefill(params, cfg, {"tokens": tok[:, :8]})
        cache = api.make_decode_cache(cfg, 2, 16, "cpu")
        api.fill_decode_cache(cfg, cache, pre)
        for t in range(8, 12):
            lg, cache = api.decode_step(params, cfg,
                                        {"tokens": tok[:, t:t + 1]}, cache, t)
            torch.testing.assert_close(lg[:, 0], full[:, t], atol=2e-4,
                                       rtol=2e-4)


# ------------------------------------------------------------------ #
# the reference at G > 1 and model > 1 (one JAX subprocess)
# ------------------------------------------------------------------ #
REF_SNIPPET = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.launch.axes import use_axis_rules
from repro.models import moe as M
from repro.models.attention import flash_decode_shardmap



def make_debug_mesh(n, model=1):
    # repro.launch.mesh.make_debug_mesh's mesh with Auto axes: this jax
    # makes Explicit ones by default, which with_sharding_constraint refuses
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((n // model, model), ("data", "model"),
                         axis_types=(auto, auto))


out = {}
FD = dict(%(FD)r)
cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                          capacity_factor=%(cf)r, dtype=jnp.float32)
params = M.init_moe(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
x = rng.normal(size=%(shape)r + (cfg.d_model,)).astype(np.float32)
out.update({f"moe_param_{k}": np.asarray(v) for k, v in params.items()})
out["moe_x"] = x
rec = {}

class _Lax:
    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, a, k):
        res = jax.lax.top_k(a, k)
        rec["top_i"] = res[1]
        return res

class _Jax:
    lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        inner = jax.vmap(fn, *a, **kw)

        def run(*args):
            res = inner(*args)
            rec.setdefault("vmap", []).append(res)
            return res
        return run

M.jax = _Jax()
for n in (2, 4):
    rec.clear()
    with use_axis_rules(make_debug_mesh(n)):
        y, aux = M.apply_moe(params, cfg, jnp.asarray(x))
    _, dest, keep = rec["vmap"][0]
    out.update({f"moe{n}_y": np.asarray(y),
                f"moe{n}_top_i": np.asarray(rec["top_i"]),
                f"moe{n}_dest": np.asarray(dest),
                f"moe{n}_keep": np.asarray(keep)})
    out.update({f"moe{n}_{k}": np.asarray(v) for k, v in aux.items()})

B, H, KV, hd, L = (FD[k] for k in ("B", "H", "KV", "hd", "L"))
fd = {"q": rng.normal(size=(B, 1, H, hd)),
      "ck": rng.normal(size=(B, L, KV, hd)),
      "cv": rng.normal(size=(B, L, KV, hd)),
      "kn": rng.normal(size=(B, 1, KV, hd)),
      "vn": rng.normal(size=(B, 1, KV, hd))}
fd = {k: v.astype(np.float32) for k, v in fd.items()}
o, ck, cv = flash_decode_shardmap(*(jnp.asarray(fd[k]) for k in
                                    ("q", "ck", "cv", "kn", "vn")),
                                  FD["slot"], FD["valid"],
                                  make_debug_mesh(4, model=4))
out.update({f"fd_{k}": v for k, v in fd.items()})
out.update({"fd_out": np.asarray(o), "fd_ck_out": np.asarray(ck),
            "fd_cv_out": np.asarray(cv)})
np.savez(sys.argv[1], **out)
print("OK")
'''


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    code = REF_SNIPPET % {"FD": FD, "cf": MOE_CF, "shape": MOE_SHAPE}
    res = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr[-3000:]
    return path


@pytest.mark.parametrize("G", [2, 4])
def test_moe_grouped_dispatch_matches_reference(ref_npz, G):
    """apply_moe at G groups (a data axis of G) against the reference's
    under use_axis_rules(make_debug_mesh(G)): routes, dest and keep
    bitwise, y and the aux losses at 1e-5."""
    ref = np.load(ref_npz)
    cfg = dataclasses.replace(tget_config("qwen3-moe-30b-a3b").smoke(),
                              capacity_factor=MOE_CF, dtype=torch.float32)
    params = {k: torch.as_tensor(ref[f"moe_param_{k}"])
              for k in ("router", "w_up", "w_gate", "w_down")}
    seen = {}
    route, slots = tmoe.route, tmoe.dispatch_slots

    def rec_route(*a):
        out = route(*a)
        seen["top_i"] = out[3]
        return out

    def rec_slots(*a):
        out = slots(*a)
        seen["dest"], seen["keep"] = out
        return out
    tmoe.route, tmoe.dispatch_slots = rec_route, rec_slots
    try:
        with taxes.use_axis_rules(_Mesh(data=G, model=1)):
            y, aux = tmoe.apply_moe(params, cfg, torch.as_tensor(ref["moe_x"]))
    finally:
        tmoe.route, tmoe.dispatch_slots = route, slots
    N = MOE_SHAPE[0] * MOE_SHAPE[1]
    np.testing.assert_array_equal(
        seen["top_i"].view(G, N // G, -1).numpy(), ref[f"moe{G}_top_i"])
    np.testing.assert_array_equal(seen["dest"].numpy(), ref[f"moe{G}_dest"])
    np.testing.assert_array_equal(seen["keep"].numpy(), ref[f"moe{G}_keep"])
    assert 0 < float(aux["dropped_frac"]) < 1
    np.testing.assert_allclose(y.numpy(), ref[f"moe{G}_y"], atol=1e-5,
                               rtol=1e-5)
    for k in ("lb_loss", "z_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), ref[f"moe{G}_{k}"],
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ #
# worlds 2 and 4 (one spawn each)
# ------------------------------------------------------------------ #
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cohort_checks(out):
    """Sharded at `world` ranks against the batched engine on COHORT
    (one-client groups) and ONE_GROUP (real clients on every rank), and
    padding a ragged group through the sharded path against the exact
    one."""
    srv = HAPFLServer(FLEnvironment(CFG), seed=0, device="cpu")
    for name, cohort in (("cohort", COHORT), ("one_group", ONE_GROUP)):
        ref = BatchedClientEngine(FLEnvironment(CFG),
                                  device="cpu").train_cohort(
            *cohort, srv.global_by_size, srv.lite_params)
        eng = ShardedClientEngine(FLEnvironment(CFG), mesh=make_debug_mesh(),
                                  device="cpu")
        got = eng.train_cohort(*cohort, srv.global_by_size, srv.lite_params)
        out["n_shards"] = eng.n_shards
        out[f"{name}_close"] = _close(ref, got)
        out[f"{name}_err"] = float(np.abs(_flat(ref) - _flat(got)).max())
    out["one_group_batches"] = np.array(
        [eng.env.loaders[c].batch_size for c in ONE_GROUP[0]])
    exact, padded = (ShardedClientEngine(
        FLEnvironment(CFG), mesh=make_debug_mesh(), device="cpu").train_cohort(
        *RAGGED, srv.global_by_size, srv.lite_params, pad_pow2=pad)
        for pad in (False, True))
    out["pad_close"] = _close(padded, exact)


def _kernel_checks(out):
    """The sharded wrappers (their plain versions here) against the
    unsharded ones on the whole tensors: bitwise."""
    mesh = make_debug_mesh()
    rng = np.random.default_rng(1)
    x, y = (torch.as_tensor(rng.normal(size=(64, 100)).astype(np.float32))
            for _ in range(2))
    lab = torch.as_tensor(rng.integers(0, 100, 64).astype(np.int32))
    whole, got = kd_loss_op(x, y, lab), sharded_kd_loss(x, y, lab, mesh)
    kd = all(torch.equal(whole[k], got[k]) for k in whole)
    h = torch.as_tensor(rng.normal(size=(32, 64)).astype(np.float32))
    s = torch.as_tensor(rng.normal(size=(64,)).astype(np.float32))
    rms = torch.equal(rmsnorm_op(h, s), sharded_rmsnorm(h, s, mesh))
    q, k, v = (torch.as_tensor(rng.normal(size=(4, 4, 16, 8)).astype(
        np.float32)) for _ in range(3))
    kv = k[:, :2], v[:, :2]
    flash = all(torch.equal(flash_attention_op(q, a, b, sliding_window=w),
                            sharded_flash_attention(q, a, b, mesh,
                                                    sliding_window=w))
                for a, b in ((k, v), kv) for w in (0, 6))
    out["kernels_equal"] = np.array([kd, rms, flash])


def _server_checks(out):
    """One round of engine="sharded" over the world: each rank's globals
    (compared across ranks by the test) and the batched server's."""
    srv = HAPFLServer(FLEnvironment(CFG), seed=3, mesh=make_debug_mesh(),
                      device="cpu")
    srv.run_round()
    out["globals"] = _flat([srv.lite_params, srv.global_by_size])
    ref = HAPFLServer(FLEnvironment(CFG), seed=3, engine="batched",
                      device="cpu")
    ref.run_round()
    out["globals_batched"] = _flat([ref.lite_params, ref.global_by_size])


def _decode_run(cfg, batch, S, n, max_len, mesh):
    """Prefill S positions, then n decode steps through models.api, under
    `mesh` (None: no mesh). Returns the steps' logits and the cache."""
    import contextlib
    from repro_torch.models import api
    params = api.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    ctx = (taxes.use_axis_rules(mesh) if mesh is not None
           else contextlib.nullcontext())
    first = {k: (v[:, :, :S] if k == "positions" else v[:, :S])
             for k, v in batch.items()}
    logits = []
    with ctx, torch.no_grad():
        _, pre = api.prefill(params, cfg, first)
        cache = api.make_decode_cache(cfg, batch_size(batch), max_len, "cpu")
        api.fill_decode_cache(cfg, cache, pre)
        for t in range(S, S + n):
            step = ({"embeddings": batch["embeddings"][:, t:t + 1]}
                    if "embeddings" in batch
                    else {"tokens": batch["tokens"][:, t:t + 1]})
            lg, cache = api.decode_step(params, cfg, step, cache, t)
            logits.append(lg)
    return torch.stack(logits), cache


def batch_size(batch):
    return next(v for k, v in batch.items() if k != "positions").shape[0]


def _decode_checks(out):
    """decode_step through the sharded flash decode against world 1: a
    qwen2-vl smoke cut (2 KV heads) on a (1, 4) mesh, and a llama smoke
    cut with 1 KV head on a (2, 2) mesh, whose batch is split over data."""
    from repro_torch.models.api import dummy_batch
    cases = {"vl": (dataclasses.replace(tget_config("qwen2-vl-2b").smoke(),
                                        dtype=torch.float32), 4),
             "dp": (dataclasses.replace(tget_config("llama3.2-3b").smoke(),
                                        n_kv_heads=1, dtype=torch.float32),
                    2)}
    for name, (cfg, model) in cases.items():
        batch = dummy_batch(cfg, 2, 18, torch.Generator().manual_seed(1),
                            with_labels=False, device="cpu")
        plain, _ = _decode_run(cfg, batch, 12, 6, 32, None)
        mesh = make_debug_mesh(model=model)
        got, cache = _decode_run(cfg, batch, 12, 6, 32, mesh)
        out[f"decode_{name}_err"] = float((plain - got).abs().max())
        out[f"decode_{name}_cache"] = np.array(cache["blocks"]["k"].shape)


def _flash_decode_checks(ref_path, out):
    """flash_decode_sharded on this rank's slice of the reference's inputs
    on a (1, 4) mesh: out and the slice against the reference's."""
    from repro_torch.models.attention import flash_decode_sharded
    ref = np.load(ref_path)
    mesh = make_debug_mesh(model=4)
    Ls = FD["L"] // 4
    mine = slice(dist.get_rank() * Ls, (dist.get_rank() + 1) * Ls)
    t = {k: torch.as_tensor(ref[f"fd_{k}"]) for k in ("q", "kn", "vn")}
    ck = torch.as_tensor(ref["fd_ck"][:, mine]).clone()
    cv = torch.as_tensor(ref["fd_cv"][:, mine]).clone()
    before = ck.clone()
    o = flash_decode_sharded(t["q"], ck, cv, t["kn"], t["vn"],
                             torch.tensor(FD["slot"]),
                             torch.tensor(FD["valid"]), mesh)
    out["fd_err"] = float(np.abs(o.numpy() - ref["fd_out"]).max())
    out["fd_cache_err"] = max(
        float(np.abs(ck.numpy() - ref["fd_ck_out"][:, mine]).max()),
        float(np.abs(cv.numpy() - ref["fd_cv_out"][:, mine]).max()))
    out["fd_wrote"] = not torch.equal(ck, before)


def _rank_main(rank, world, port, out_dir, ref_path):
    """One rank of a gloo world on the CPU: its checks into rank<r>.npz."""
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    backend, _ = init_world(rank, world, f"tcp://localhost:{port}",
                            device="cpu")
    out = {"backend": backend}
    try:
        _cohort_checks(out)
        if world == 2:
            _kernel_checks(out)
            _server_checks(out)
        else:
            _decode_checks(out)
            _flash_decode_checks(ref_path, out)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def _spawn(world, tmp_path_factory, ref_path):
    import torch.multiprocessing as mp
    out_dir = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(_rank_main, args=(world, _free_port(), str(out_dir),
                               str(ref_path)),
             nprocs=world, join=True)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ref_npz):
    return _spawn(2, tmp_path_factory, ref_npz)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, ref_npz):
    return _spawn(4, tmp_path_factory, ref_npz)


@pytest.fixture(params=[2, 4])
def world(request, world2, world4):
    return {2: world2, 4: world4}[request.param]


def test_ranks_run_gloo_on_the_cpu(world):
    assert all(str(r["backend"]) == "gloo" for r in world)


def test_cohort_parity_across_ranks(world):
    assert [int(r["n_shards"]) for r in world] == [len(world)] * len(world)
    # ONE_GROUP is one dispatch group of 4 real clients
    assert world[0]["one_group_batches"].tolist() == [32] * 4
    for r in world:
        assert bool(r["cohort_close"]), float(r["cohort_err"])
        assert bool(r["one_group_close"]), float(r["one_group_err"])


def test_pad_invariance_across_ranks(world):
    assert all(bool(r["pad_close"]) for r in world)


def test_sharded_kernels_bitwise_at_world_2(world2):
    for r in world2:
        assert r["kernels_equal"].tolist() == [True, True, True]


def test_server_globals_equal_across_ranks(world2):
    a, b = (r["globals"] for r in world2)
    assert a.tobytes() == b.tobytes()
    np.testing.assert_allclose(a, world2[0]["globals_batched"], atol=1e-5,
                               rtol=1e-4)


def test_sharded_decode_matches_world_1(world4):
    for r in world4:
        assert float(r["decode_vl_err"]) <= 1e-5
        assert float(r["decode_dp_err"]) <= 1e-5
        # qwen2-vl smoke: 2 layers, B 2, 32 / 4 slots, 2 KV heads, hd 64
        assert r["decode_vl_cache"].tolist() == [2, 2, 8, 2, 64]
        # (2, 2) mesh: the batch split over data, the length over model
        assert r["decode_dp_cache"].tolist() == [2, 1, 16, 1, 64]


def test_flash_decode_matches_reference(world4):
    for r in world4:
        assert float(r["fd_err"]) <= 1e-5
        assert float(r["fd_cache_err"]) <= 1e-5
    # the slot (20 of 32) is in the third slice: only that rank writes
    assert [bool(r["fd_wrote"]) for r in world4] == [False, False, True,
                                                     False]
