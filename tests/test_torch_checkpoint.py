"""repro_torch.checkpoint on the CPU: the round trips of
tests/test_checkpoint.py on torch trees, and the on-disk format shared with
the reference, bitwise in both directions.

The format is the reference's: `<path>.npz` of the leaves under the
reference's `_flatten` keys plus `<path>.json` with the step and each
leaf's dtype, bf16 as its uint16 view. So the reference's checkpoint of
JAX llama3.2-3b smoke params, fp32 and bf16, restores in the port to
exactly `params_from_numpy` of the same params, and the port's restores in
the reference to exactly the JAX params; every comparison here is bitwise
(torch.equal / np.array_equal and equal dtypes), no tolerance."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_checkpoint as jload, save_checkpoint as jsave
from repro.checkpoint.ckpt import _flatten as jflatten
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.checkpoint import (load_checkpoint, load_checkpoint_flat,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.convert import params_from_numpy
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _tree_equal(a, b):
    """Same structure, dtypes and bits (numpy leaves taken as tensors)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    x, y = _t(a), _t(b)
    return x.dtype == y.dtype and torch.equal(x, y)


def _mixed_tree():
    return {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": np.float32(1.5), "ints": torch.arange(4)},
        "stack": [np.ones((3,), np.float32), {"deep": torch.zeros((2, 2))}],
        "mask": np.array([True, False, True]),
        "f64": torch.linspace(0, 1, 5, dtype=torch.float64),
    }


# ---------------------------------------------------------------------- #
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------- #
def test_mixed_tree_roundtrip(tmp_path):
    tree = _mixed_tree()
    save_checkpoint(tmp_path / "ck", tree, step=11)
    restored, step = load_checkpoint(tmp_path / "ck", tree, device="cpu")
    assert step == 11
    assert _tree_equal(tree, restored)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(restored))


def test_bf16_view_roundtrip(tmp_path):
    tree = {"p": torch.linspace(-3, 3, 16).to(torch.bfloat16).reshape(4, 4),
            "q": torch.ones(3)}
    save_checkpoint(tmp_path / "bf", tree)
    meta = json.loads((tmp_path / "bf.json").read_text())
    assert meta["leaves"] == {"p": "bfloat16", "q": "float32"}
    assert np.load(tmp_path / "bf.npz")["p"].dtype == np.uint16
    restored, _ = load_checkpoint(tmp_path / "bf", tree, device="cpu")
    assert restored["p"].dtype == torch.bfloat16
    assert torch.equal(restored["p"], tree["p"])     # bit-exact via uint16
    flat, _ = load_checkpoint_flat(tmp_path / "bf", device="cpu")
    assert flat["p"].dtype == torch.bfloat16
    assert torch.equal(flat["p"], tree["p"])


def test_ppo_agent_state_roundtrip(tmp_path):
    """The state the parameter service checkpoints for each PPO agent:
    params + AdamW state (its int32 step included) + buffer entries."""
    from repro_torch.core.ppo import PPOAgent, PPOConfig
    agent = PPOAgent(PPOConfig(state_dim=4, kind="categorical_multihead"),
                     torch.Generator().manual_seed(0), device="cpu")
    agent.store(np.ones(4), np.zeros(4, np.int32), -0.3, 1.25)
    tree = {"params": agent.params, "opt": agent.opt_state,
            "buffer": {"0": dict(agent.buffer[0])}}
    save_checkpoint(tmp_path / "ppo", tree)
    restored, _ = load_checkpoint(tmp_path / "ppo", tree, device="cpu")
    assert _tree_equal(tree, restored)
    assert restored["opt"]["step"].dtype == torch.int32


def test_flat_restore_matches_flatten_keys(tmp_path):
    tree = _mixed_tree()
    save_checkpoint(tmp_path / "ck", tree, step=3)
    flat, step = load_checkpoint_flat(tmp_path / "ck", device="cpu")
    assert step == 3
    want = _flatten(tree)
    assert set(flat) == set(want)
    for k in want:
        assert torch.equal(flat[k], _t(want[k]))


def test_missing_leaf_error_names_the_leaf(tmp_path):
    save_checkpoint(tmp_path / "ck", {"a": torch.ones(2)})
    like = {"a": torch.ones(2), "brand_new": {"w": torch.zeros(3)}}
    with pytest.raises(KeyError, match="brand_new/w"):
        load_checkpoint(tmp_path / "ck", like, device="cpu")


def test_extra_leaf_error_names_the_leaf(tmp_path):
    save_checkpoint(tmp_path / "ck",
                    {"a": torch.ones(2), "stale": {"w": torch.zeros(3)}})
    with pytest.raises(KeyError, match="stale/w"):
        load_checkpoint(tmp_path / "ck", {"a": torch.ones(2)}, device="cpu")


def test_both_directions_reported_and_clipped(tmp_path):
    save_checkpoint(tmp_path / "ck",
                    {f"old_{i}": torch.ones(1) for i in range(10)})
    with pytest.raises(KeyError) as ei:
        load_checkpoint(tmp_path / "ck", {"new_leaf": torch.ones(1)},
                        device="cpu")
    msg = str(ei.value)
    assert "new_leaf" in msg and "old_0" in msg
    assert "more)" in msg              # long key lists are clipped, not dumped


def test_torn_checkpoint_detected(tmp_path):
    """Meta json and npz disagreeing = corrupted/torn write -> loud error."""
    tree = {"a": torch.ones(2), "b": torch.zeros(3)}
    save_checkpoint(tmp_path / "ck", tree)
    meta = json.loads((tmp_path / "ck.json").read_text())
    del meta["leaves"]["b"]
    (tmp_path / "ck.json").write_text(json.dumps(meta))
    with pytest.raises(KeyError, match="npz"):
        load_checkpoint(tmp_path / "ck", tree, device="cpu")
    with pytest.raises(KeyError, match="npz"):
        load_checkpoint_flat(tmp_path / "ck", device="cpu")


# ---------------------------------------------------------------------- #
# across the two packages
# ---------------------------------------------------------------------- #
def _llama_params(dtype):
    """JAX llama3.2-3b smoke params in `dtype`, and the port's
    `params_from_numpy` of them."""
    jcfg = dataclasses.replace(jget_config("llama3.2-3b").smoke(),
                               dtype=dtype)
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _assert_jax_equal(got, exp):
    """A JAX tree against a JAX tree: structure, dtypes and bits."""
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(exp))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(exp)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    jp, tp = _llama_params(getattr(jnp, dtype))
    jsave(tmp_path / "ref", jp, step=7)
    got, step = load_checkpoint(tmp_path / "ref", tp, device="cpu")
    assert step == 7
    assert _tree_equal(got, tp)
    assert {t.dtype for t in tree_leaves(got)} == {getattr(torch, dtype)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    jp, tp = _llama_params(getattr(jnp, dtype))
    save_checkpoint(tmp_path / "port", tp, step=5)
    got, step = jload(tmp_path / "port", jp)
    assert step == 5
    _assert_jax_equal(got, jp)
    # the same json meta the reference writes for the same tree
    jsave(tmp_path / "ref", jp, step=5)
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def test_port_keys_are_the_reference_flatten_keys():
    """The same key set, in the same order (dict keys sorted), as the
    reference's `_flatten` of the same tree — here a tree whose insertion
    order is not sorted, with lists, tuples and None nodes."""
    jp, tp = _llama_params(jnp.float32)
    mixed = lambda arr: {"z": [arr(1.0), (arr(2.0), None)], "a": arr(3.0),
                         "m": {"k2": arr(4.0), "k10": arr(5.0)}}
    for j, t in ((jp, tp), (mixed(jnp.float32), mixed(torch.tensor))):
        assert list(_flatten(t)) == list(jflatten(j))


def test_launch_train_checkpoint_restores_in_the_reference(tmp_path):
    """`launch/train.py --checkpoint` writes the trained params, which the
    reference's load_checkpoint restores bitwise into its own structure."""
    from repro.train.step import make_train_state as jmake_train_state
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.train import main
    path = str(tmp_path / "llama")
    state = main(["--arch", "llama3.2-3b", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--checkpoint", path,
                  "--device", "cpu"])
    cfg = jget_config("llama3.2-3b").smoke()
    lite = dataclasses.replace(cfg.lite(), dtype=jnp.float32, remat=False,
                               scan_layers=False)
    like = jmake_train_state(jax.random.PRNGKey(1), cfg, lite)["params"]
    got, step = jload(path, like)
    assert step == 2
    exp = jax.tree_util.tree_map(jnp.asarray,
                                 params_to_numpy(state["params"]))
    _assert_jax_equal(got, exp)


def test_moe_checkpoint_crosses_packages_bitwise(tmp_path):
    """An MoE tree (qwen3-moe smoke in bf16: fp32 routers among bf16 expert
    stacks) both ways: the reference's checkpoint restores in the port to
    exactly `params_from_numpy` of its params, and the port's restores in
    the reference to exactly the JAX params, with the same json meta."""
    jcfg = dataclasses.replace(jget_config("qwen3-moe-30b-a3b").smoke(),
                               dtype=jnp.bfloat16)
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    jsave(tmp_path / "ref", jp, step=3)
    got, step = load_checkpoint(tmp_path / "ref", tp, device="cpu")
    assert step == 3 and _tree_equal(got, tp)
    save_checkpoint(tmp_path / "port", tp, step=3)
    back, step = jload(tmp_path / "port", jp)
    assert step == 3
    _assert_jax_equal(back, jp)
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def test_launch_train_moe_checkpoint_restores_in_the_reference(tmp_path):
    """`launch/train.py --arch qwen3-moe-30b-a3b --smoke --checkpoint`: the
    reference restores the trained MoE params bitwise into its own
    structure."""
    from repro.train.step import make_train_state as jmake_train_state
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.train import main
    path = str(tmp_path / "moe")
    state = main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--checkpoint", path,
                  "--device", "cpu"])
    cfg = jget_config("qwen3-moe-30b-a3b").smoke()
    lite = dataclasses.replace(cfg.lite(), dtype=jnp.float32, remat=False,
                               scan_layers=False)
    like = jmake_train_state(jax.random.PRNGKey(1), cfg, lite)["params"]
    got, step = jload(path, like)
    assert step == 2
    exp = jax.tree_util.tree_map(jnp.asarray,
                                 params_to_numpy(state["params"]))
    _assert_jax_equal(got, exp)
