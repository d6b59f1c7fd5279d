"""The port's transformer training path against the reference on the CPU:
`train/step.py::make_hapfl_train_step` (plain, microbatched and
loss-chunked), the in-place AdamW step, clip_by_global_norm and the
schedules, `launch/train.py::token_batches`, remat, and `fl/llm_fleet.py`'s
client streams and rounds. Params are made by the reference and carried
over through numpy; the config is the fp32 smoke cut of llama3.2-3b with 2
KV heads of 4 (GQA) and its LiteModel. The train step is also held, plain
and loss-chunked, on the smoke cuts of granite-3-8b (untied embeddings),
granite-20b (layernorm, GELU, one KV head) and olmo-1b (non-parametric
layernorm), and, plain, microbatched and loss-chunked, on the MoE smoke
cuts of qwen3-moe-30b-a3b and mixtral-8x7b (the router's lb_loss and
z_loss in the loss; lb_loss among the metrics).

Tolerances: loss, metrics, grad norm and gradients atol 1e-5, rtol 1e-4.
New params are compared only where the reference's gradient is at least
1e-4 in size (the fleet's aggregates: 1e-5 at every local step): Adam's
first step moves each parameter by about lr times the sign of its
gradient, so float noise in a near-zero gradient becomes a move of +-lr
(ROADMAP §3 notes the same of PPO2). Token streams are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.fl.llm_fleet import FleetConfig as JFleetConfig
from repro.fl.llm_fleet import LLMFleet as JLLMFleet
from repro.launch.train import token_batches as jtoken_batches
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.fl.llm_fleet import FleetConfig, LLMFleet
from repro_torch.launch.train import token_batches
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch="llama3.2-3b"):
    """(reference local, lite), (port local, lite): the fp32 smoke cut of
    `arch` and its LiteModel, as the reference's fleet and launch/train.py
    --smoke cut them; llama3.2-3b with 2 KV heads of 4 (GQA)."""
    out = []
    for get, dt in ((jget_config, jnp.float32), (tget_config, torch.float32)):
        cfg = get(arch).smoke()
        if arch == "llama3.2-3b":
            cfg = dataclasses.replace(cfg, n_kv_heads=2)
        lite = dataclasses.replace(cfg.lite(), dtype=dt, remat=False,
                                   scan_layers=False)
        out.append((cfg, lite))
    return out


def _batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    chunk = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return chunk[:, :-1], chunk[:, 1:]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


@pytest.fixture(scope="module")
def setups():
    """arch -> (reference local, lite, port local, lite, reference params),
    each made once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            (jcfg, jlite), (tcfg_, tlite) = _cfgs(arch)
            jstate = jstep.make_train_state(jax.random.PRNGKey(0), jcfg,
                                            jlite)
            made[arch] = (jcfg, jlite, tcfg_, tlite,
                          jax.device_get(jstate["params"]))
        return made[arch]
    return get


@pytest.fixture(scope="module")
def setup(setups):
    return setups("llama3.2-3b")


@pytest.mark.parametrize("arch,mode", [
    pytest.param("llama3.2-3b", m, id=m)
    for m in ("plain", "microbatch", "loss_chunk")] + [
    pytest.param(a, m, id=f"{a}-{m}")
    for a in ("granite-3-8b", "granite-20b", "olmo-1b")
    for m in ("plain", "loss_chunk")] + [
    pytest.param(a, m, id=f"{a}-{m}")
    for a in ("qwen3-moe-30b-a3b", "mixtral-8x7b")
    for m in ("plain", "microbatch", "loss_chunk")])
def test_train_step_matches_reference(setups, arch, mode):
    jcfg, jlite, tcfg_, tlite, jparams = setups(arch)
    kw = {"plain": {}, "microbatch": {"microbatch": 2},
          "loss_chunk": {"loss_chunk": 8}}[mode]
    jt = jstep.TrainStepConfig(**kw)
    tt = tstep.TrainStepConfig(**kw)
    tok, lab = _batch(jcfg)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": torch.from_numpy(tok).long(),
              "labels": torch.from_numpy(lab).long()}

    # gradients of one batch (the microbatched step's are its mean)
    def jloss(p, b):
        return jstep._losses(p, jcfg, jlite, jt, b)

    if mode == "microbatch":
        halves = [{k: v[i * 2:(i + 1) * 2] for k, v in jbatch.items()}
                  for i in range(2)]
        gs = [jax.grad(lambda p, b=b: jloss(p, b)[0])(jparams)
              for b in halves]
        jgrads = jax.tree_util.tree_map(lambda a, b: a / 2 + b / 2, *gs)
    else:
        jgrads = jax.grad(lambda p: jloss(p, jbatch)[0])(jparams)
    jgrads = jax.device_get(jgrads)

    jnew, jm = jax.jit(jstep.make_hapfl_train_step(jcfg, jlite, jt))(
        {"params": jparams,
         "opt": jopt.adamw(jt.lr).init(jparams)}, jbatch)
    jnew = jax.device_get(jnew["params"])

    params = params_from_numpy(jparams, device="cpu")
    if mode != "microbatch":
        _, grads = tstep.loss_and_grads(params, tcfg_, tlite, tt, tbatch)
        for path in _paths(grads):
            np.testing.assert_allclose(_at(grads, path).numpy(),
                                       _at(jgrads, path), **TOL,
                                       err_msg=str(path))

    state = {"params": params,
             "opt": topt.adamw(tt.lr).init(params)}
    state, tm = tstep.make_hapfl_train_step(tcfg_, tlite, tt)(state, tbatch)
    assert set(tm) == set(jm)
    assert ("lb_loss" in tm) == jcfg.is_moe
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(tm["grad_norm"]),
        float(np.sqrt(sum(np.sum(np.square(g))
                          for g in jax.tree_util.tree_leaves(jgrads)))),
        **TOL)
    moved = 0
    for path in _paths(jnew):
        got = _at(state["params"], path).numpy()
        mask = np.abs(_at(jgrads, path)) >= 1e-4
        np.testing.assert_allclose(got[mask], _at(jnew, path)[mask], **TOL,
                                   err_msg=str(path))
        moved += int(mask.sum())
    assert moved > 1000
    assert int(state["opt"]["step"]) == 1


def test_remat_changes_no_gradient():
    """cfg.remat (torch.utils.checkpoint per block) gives the gradients of
    the same model run without it, bit for bit on the CPU."""
    (_, _), (cfg, _) = _cfgs()
    params = tapi.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.from_numpy(_batch(cfg)[0]).long()
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        logits, _ = tapi.forward(tree_unflatten(params, leaves), c,
                                 {"tokens": tok})
        grads.append(torch.autograd.grad((logits ** 2).mean(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_adamw_in_place_is_the_functional_update_bitwise():
    """update_ (leaf by leaf, in slices, m and v written in place, the clip
    factor applied to fp32 gradients) gives the bits of update + tree_add
    on the clipped gradients, over three steps, for fp32 and bf16 params
    and with weight decay and a cosine schedule."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        params = {"a": torch.from_numpy(rng.standard_normal((5, 7, 3))
                                        .astype(np.float32)).to(dtype),
                  "b": [torch.from_numpy(rng.standard_normal(11)
                                         .astype(np.float32)).to(dtype)]}
        opt = topt.adamw(topt.cosine_schedule(1e-2, 10, warmup=2),
                         weight_decay=0.1)
        ref_p = tree_map(torch.clone, params)
        ref_s = opt.init(ref_p)
        state = opt.init(params)
        old, topt.SLICE_ELEMENTS = topt.SLICE_ELEMENTS, 8   # 2 slices of a
        try:
            for i in range(3):
                grads = tree_map(lambda p: torch.from_numpy(
                    rng.standard_normal(tuple(p.shape)).astype(np.float32)
                ).to(dtype), params)
                clipped, gn = topt.clip_by_global_norm(grads, 1.0)
                upd, ref_s = opt.update(clipped, ref_s, ref_p)
                ref_p = tree_map(lambda p, u: p + u, ref_p, upd)
                opt.update_(grads, state, params,
                            topt.clip_scale(topt.global_norm(grads), 1.0))
        finally:
            topt.SLICE_ELEMENTS = old
        for a, b in zip(tree_leaves((params, state["m"], state["v"])),
                        tree_leaves((ref_p, ref_s["m"], ref_s["v"]))):
            assert torch.equal(a, b)
        assert int(state["step"]) == int(ref_s["step"]) == 3


def test_clip_and_schedules_match_reference():
    rng = np.random.default_rng(4)
    # keys in sorted order, the order of jax's leaves and the port's alike
    g = {"b": [rng.standard_normal(4).astype(np.float32)],
         "w": rng.standard_normal((6, 5)).astype(np.float32) * 3}
    jc, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      1.0)
    tc, tn = topt.clip_by_global_norm(
        params_from_numpy(g, device="cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for jsched, tsched in (
            (jopt.cosine_schedule(3e-4, 20, warmup=5),
             topt.cosine_schedule(3e-4, 20, warmup=5)),
            (jopt.constant_schedule(3e-4), topt.constant_schedule(3e-4))):
        for step in (0, 1, 4, 5, 12, 20, 30):
            np.testing.assert_allclose(
                float(tsched(torch.tensor(step, dtype=torch.int32))),
                float(jsched(step)), rtol=1e-6)


@pytest.mark.parametrize("steps,seed", [(3, 0), (2, 5)])
def test_token_batches_match_reference(steps, seed):
    cfg = tget_config("llama3.2-3b").smoke()
    jcfg = jget_config("llama3.2-3b").smoke()
    got = list(token_batches(cfg, 2, 16, steps, seed, device="cpu"))
    exp = list(jtoken_batches(jcfg, 2, 16, steps, seed))
    assert len(got) == len(exp) == steps
    for a, b in zip(got, exp):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.fixture(scope="module")
def fleets():
    cfg = dict(n_clients=4, k_per_round=2, seq=16, batch=2,
               default_steps=2)
    return JLLMFleet(JFleetConfig(**cfg)), LLMFleet(FleetConfig(**cfg),
                                                    device="cpu")


def test_fleet_client_streams_match_reference(fleets):
    jf, tf = fleets
    assert len(tf.client_tokens) == len(jf.client_tokens)
    for a, b in zip(tf.client_tokens, jf.client_tokens):
        np.testing.assert_array_equal(a, b)
    assert tf.entropies == jf.entropies
    # the configs, field by field; the port's llama names its true source
    # (ROADMAP §3)
    for a, b in ((tf.pool["small"], jf.pool["small"]),
                 (tf.pool["large"], jf.pool["large"]), (tf.lite, jf.lite)):
        assert dict(a.asdict(), source="") == dict(b.asdict(), source="")


def _hold_round(jf, tf, sizes, taus, g_min):
    """One round on both fleets from the reference's globals, with `sizes`
    and `taus` injected; the checks of test_fleet_rounds_match_reference.
    jf's steps record the least |g_ref| of each element into g_min."""
    # each round from the reference's globals, so that no excused element
    # of one round moves the gradients of the next
    tf.global_by_size = {s: params_from_numpy(jax.device_get(p),
                                              device="cpu")
                         for s, p in jf.global_by_size.items()}
    tf.lite_params = params_from_numpy(jax.device_get(jf.lite_params),
                                       device="cpu")
    g_min.clear()
    for f in (jf, tf):
        f.allocator.allocate = lambda key, assess, s=sizes: (s, None)
        f.intensity.assign = lambda key, mod, t=taus: (t, None)
        f.allocator.feedback = f.intensity.feedback = lambda *a: 0.0
    jr, tr = jf.run_round(), tf.run_round()
    for k in ("round", "clients", "sizes", "taus", "straggling"):
        assert tr[k] == jr[k], k
    for k in ("acc_local_mean", "acc_lite_mean"):
        np.testing.assert_allclose(tr[k], jr[k], atol=1e-6)
    trees = {"lite": (tf.lite_params, jf.lite_params)}
    trees.update({s: (tf.global_by_size[s], jf.global_by_size[s])
                  for s in set(sizes)})
    for name, (got, exp) in trees.items():
        exp = jax.device_get(exp)
        held = total = 0
        for path in _paths(exp):
            mask = _at(g_min[name], path) >= 1e-5
            np.testing.assert_allclose(
                _at(got, path).numpy()[mask], _at(exp, path)[mask],
                atol=1e-4, rtol=0, err_msg=str((sizes, name, path)))
            held += int(mask.sum())
            total += mask.size
        assert held >= 0.7 * total, (sizes, name, held, total)


def _record_grads(jf, g_min):
    """Wrap jf's train steps so that each records the least |g_ref| of each
    element over the local steps into g_min."""
    def recorded(s, step):
        def run(state, batch):
            g = jax.grad(lambda p: jstep._losses(
                p, jf.pool[s], jf.lite, jf.tcfg, batch)[0])(state["params"])
            for name, tree in (("lite", g["lite"]), (s, g["local"])):
                size = jax.tree_util.tree_map(
                    lambda t: np.abs(np.asarray(t)), tree)
                g_min[name] = size if name not in g_min else \
                    jax.tree_util.tree_map(np.minimum, g_min[name], size)
            return step(state, batch)
        return run

    jf._steps = {s: recorded(s, f) for s, f in jf._steps.items()}


def test_fleet_rounds_match_reference(fleets):
    """Two rounds on both sides, each from the reference's globals, with the
    PPO agents' sizes and intensities injected: clients, sizes and taus
    equal, straggling exact, and the aggregated lite and size globals at
    atol 1e-4 wherever the reference's gradient was at least 1e-5 in size
    at every local step that fed them (the module's docstring says why an
    element with a near-zero gradient is excused; 1e-5 rather than the
    step test's 1e-4 because the lite's gradients are small). At least 70%
    of each aggregate is held."""
    jf, tf = fleets
    g_min = {}     # the least |g_ref| of each element over a round's steps
    _record_grads(jf, g_min)
    plans = [(["small", "large"], [2, 1]), (["large", "large"], [1, 2])]
    for sizes, taus in plans:
        _hold_round(jf, tf, sizes, taus, g_min)


def test_moe_fleet_round_matches_reference():
    """One round of a fleet of qwen3-moe smoke clients (the router's aux
    losses in every local step's loss), sizes and intensities injected, with
    the checks of test_fleet_rounds_match_reference. One local step a
    client: at a second Adam step, an element whose two gradients have
    opposite signs has its first moment cancelled, and float noise in the
    gradients moves it by more than 1e-4 (the lite's w_gate at taus [2, 1]:
    gradients -9.1e-5 then 4.7e-5, 1.4e-4 apart), which is the conditioning
    of Adam and not of the model."""
    cfg = dict(arch="qwen3-moe-30b-a3b", n_clients=4, k_per_round=2,
               seq=16, batch=2, default_steps=2)
    jf = JLLMFleet(JFleetConfig(**cfg))
    tf = LLMFleet(FleetConfig(**cfg), device="cpu")
    assert all(c.is_moe for c in tf.pool.values())
    g_min = {}
    _record_grads(jf, g_min)
    _hold_round(jf, tf, ["small", "large"], [1, 1], g_min)


def test_launch_train_main_runs_on_cpu(capsys):
    """The entry point with the reference's flags: a few smoke steps on the
    CPU, a printed loss per step and finite params."""
    from repro_torch.launch.train import main
    state = main(["--arch", "llama3.2-3b", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("loss=") == 2
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state["params"]))
    assert int(state["opt"]["step"]) == 2


def test_launch_train_main_trains_an_moe_arch_on_cpu(capsys):
    """The entry point on qwen3-moe's smoke cut: 2 steps, a printed loss per
    step (the router's aux losses in it), finite params."""
    from repro_torch.launch.train import main
    state = main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert capsys.readouterr().out.count("loss=") == 2
    assert "moe" in state["params"]["local"]["blocks"]
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state["params"]))
    assert int(state["opt"]["step"]) == 2


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_launch_train_main_trains_vlm_and_audio_on_cpu(capsys, arch):
    """The entry point on the VLM's and the audio model's smoke cuts: 2
    steps (patch embeddings with M-RoPE positions; codebook tokens), a
    printed loss per step, finite params."""
    from repro_torch.launch.train import main
    state = main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--device", "cpu"])
    assert capsys.readouterr().out.count("loss=") == 2
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state["params"]))
    assert int(state["opt"]["step"]) == 2


@pytest.mark.parametrize("arch,checkpoint", [("xlstm-1.3b", True),
                                             ("zamba2-7b", False)])
def test_launch_train_main_trains_ssm_and_hybrid_on_cpu(capsys, tmp_path,
                                                       arch, checkpoint):
    """The entry point on the xLSTM's and the hybrid's smoke cuts: 2 steps
    on 16-token sequences, a printed loss per step, finite params; xlstm
    with --checkpoint, which the reference's load_checkpoint restores leaf
    for leaf (the layout's keys, the step)."""
    from repro_torch.launch.train import main
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu"]
    prefix = tmp_path / "ckpt"
    if checkpoint:
        argv += ["--checkpoint", str(prefix)]
    state = main(argv)
    out = capsys.readouterr().out
    assert out.count("loss=") == 2
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state["params"]))
    assert int(state["opt"]["step"]) == 2
    keys = ({"io", "mlstm", "slstm"} if arch == "xlstm-1.3b"
            else {"io", "mamba", "shared"})
    assert set(state["params"]["local"]) == keys
    if checkpoint:
        from repro.checkpoint import load_checkpoint as jload
        from repro_torch.convert import params_to_numpy
        cfg = jget_config(arch).smoke()
        lite = dataclasses.replace(cfg.lite(), dtype=jnp.float32,
                                   remat=False, scan_layers=False)
        like = jstep.make_train_state(jax.random.PRNGKey(1), cfg,
                                      lite)["params"]
        got, step = jload(str(prefix), like)
        assert step == 2
        exp = params_to_numpy(state["params"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
            node = exp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(np.asarray(leaf), node,
                                          err_msg=str(path))
