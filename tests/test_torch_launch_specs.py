"""The port's launch tooling against the reference's, on the CPU: the
meta-device step inputs (launch/specs.py), the FSDP x TP sharding rules and
their placement (launch/sharding.py), and the static validation
(launch/validate.py).

Parity is exact throughout. Specs: every leaf of every config x INPUT_SHAPES
in path and shape, dtypes equal but for tokens, labels and the decode
position (the reference's int32 is the port's int64). Rules: every leaf's
spec, as a tuple, equals the reference's PartitionSpec on the meshes
(16, 16), (2, 16, 16), (4, 8), (1, 8) and (2, 2), taken as jax
AbstractMeshes (no devices). Placement: each `shard_tree` block has the
reference's `shard_shape`; on the meshes that 8 host devices form, each
rank's block holds the elements `NamedSharding.devices_indices_map` gives
the matching device (one JAX subprocess); `shard_tree` -> `gather_tree` is
bitwise at world 2 on the CPU (gloo, spawned). validate: `check` gives the
reference's list, `analytic_hbm_train` the reference's value to 1e-12.
"""
import functools
import json
import math
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import validate as jvalidate  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import validate as tvalidate  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 8), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2), ("data", "model"))]
# the leaves whose dtype is the port's int64 where the reference's is int32
INT64_KEYS = {"tokens", "labels", "cache_index"}

_REF = {}
_OWN = {}


def _ref_trees(arch):
    """The reference's eval_shape trees of `arch`, made once per config:
    params and the train state."""
    if arch not in _REF:
        cfg = jget_config(arch)
        _REF[arch] = {
            "params": jspecs.params_specs(cfg),
            "state": jspecs.train_state_specs(cfg, cfg.lite()),
        }
    return _REF[arch]


def _ref_inputs(arch, shape_name):
    """The reference's input_specs, from the cached trees."""
    cfg = jget_config(arch)
    shape = INPUT_SHAPES[shape_name]
    trees = _ref_trees(arch)
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return {"state": trees["state"],
                "batch": jspecs.batch_specs(cfg, B, S)}
    if shape.mode == "prefill":
        return {"params": trees["params"],
                "batch": jspecs.batch_specs(cfg, B, S, with_labels=False)}
    return {"params": trees["params"],
            "batch": jspecs.batch_specs(cfg, B, 1, with_labels=False),
            "cache": jspecs.cache_specs(cfg, B, S),
            "cache_index": jax.ShapeDtypeStruct((), jnp.int32)}


def _own_inputs(arch, shape_name):
    """The port's input_specs, made once per (config, shape)."""
    key = (arch, shape_name)
    if key not in _OWN:
        _OWN[key] = tspecs.input_specs(tget_config(arch),
                                       INPUT_SHAPES[shape_name])
    return _OWN[key]


@functools.lru_cache(maxsize=None)
def _ref_shard_shape(mesh, spec, shape):
    return tuple(NamedSharding(_jmesh(*mesh), P(*spec)).shard_shape(shape))


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path)] = leaf
    return out


def _tflat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, path + (str(i),)))
        return out
    return {path: tree}


def _spec_flat(tree, path=()):
    """Flatten a spec tree: a spec (a tuple of entries) is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_flat(v, path + (str(k),)))
        return out
    return {path: tuple(tree)}


def _tname(dtype):
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    ref = _jflat(_ref_inputs(arch, shape_name))
    own = _tflat(_own_inputs(arch, shape_name))
    assert set(own) == set(ref)
    for path, leaf in own.items():
        assert leaf.device.type == "meta", path
        r = ref[path]
        assert tuple(leaf.shape) == tuple(r.shape), path
        want = str(r.dtype)
        if path[-1] in INT64_KEYS:
            assert want == "int32"
            want = "int64"
        assert _tname(leaf.dtype) == want, path


def _jmesh(sizes, names):
    return AbstractMesh(sizes, names)


def _tmesh(sizes, names):
    return tsharding.MeshShape(sizes, names)


def _jspecs(tree):
    return {p: tuple(s.spec) for p, s in _jflat(tree).items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_match_reference(arch, mesh):
    """params, AdamW state, every shape's batch and every decode cache."""
    jm, tm = _jmesh(*mesh), _tmesh(*mesh)
    cfg = tget_config(arch)
    state = tspecs.train_state_specs(cfg, cfg.lite())
    jstate = _ref_trees(arch)["state"]
    assert _spec_flat(tsharding.params_shardings(state["params"], tm)) == \
        _jspecs(jsharding.params_shardings(jstate["params"], jm))
    assert _spec_flat(tsharding.opt_shardings(state["opt"], None, tm)) == \
        _jspecs(jsharding.opt_shardings(jstate["opt"], None, jm))
    for shape_name, shape in INPUT_SHAPES.items():
        ref = _ref_inputs(arch, shape_name)
        own = _own_inputs(arch, shape_name)
        B = shape.global_batch
        assert tsharding.batch_axes(tm, B) == jsharding.batch_axes(jm, B)
        assert _spec_flat(tsharding.batch_shardings(own["batch"], tm, B)) \
            == _jspecs(jsharding.batch_shardings(ref["batch"], jm, B))
        if shape.mode == "decode":
            assert _spec_flat(tsharding.cache_shardings(own["cache"], tm,
                                                        B)) == \
                _jspecs(jsharding.cache_shardings(ref["cache"], jm, B))


def _blocks_and_specs(arch, tm):
    """(input tree, spec tree) pairs of `arch` at every shape: state,
    params, batch, cache."""
    from repro_torch.launch.dryrun import input_shardings
    for shape_name, shape in INPUT_SHAPES.items():
        specs = _own_inputs(arch, shape_name)
        yield specs, input_shardings(specs, shape, tm)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_tree_blocks_have_reference_shard_shape(arch):
    for mesh in MESHES:
        tm = _tmesh(*mesh)
        for specs, shardings in _blocks_and_specs(arch, tm):
            blocks = _tflat(tsharding.shard_tree(
                specs, shardings, tm, {a: 0 for a in mesh[1]}))
            flat_specs = _spec_flat(shardings)
            for path, leaf in _tflat(specs).items():
                spec = flat_specs[path]
                want = _ref_shard_shape(mesh, spec, tuple(leaf.shape))
                assert tuple(blocks[path].shape) == want, (path, spec)
                assert tsharding.shard_shape(leaf.shape, spec, tm) == want
            total = sum(math.prod(_ref_shard_shape(
                mesh, flat_specs[p], tuple(leaf.shape))) * leaf.element_size()
                for p, leaf in _tflat(specs).items())
            assert tsharding.tree_bytes(specs, shardings, tm) == total


# the placement against NamedSharding on 8 host devices
HOST_MESHES = [((4, 2), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model")),
               ((1, 8), ("data", "model"))]
INDICES_SNIPPET = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    todo = json.loads(sys.stdin.read())
    out = []
    for sizes, names, cases in todo:
        devs = np.array(jax.devices()[:8]).reshape(sizes)
        mesh = Mesh(devs, tuple(names))
        per_mesh = []
        for shape, spec in cases:
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
                tuple(shape))
            per_pos = []
            for pos in np.ndindex(*sizes):
                sl = idx[devs[pos]]
                per_pos.append([list(pos), [[s.start or 0, s.stop
                                             if s.stop is not None else n]
                                            for s, n in zip(sl, shape)]])
            per_mesh.append(per_pos)
        out.append(per_mesh)
    print(json.dumps(out))
""")


def _host_cases():
    """(leaf, spec) of smoke-cut llama and mixtral params, AdamW state and
    batch and decode caches at B 8, per host mesh."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import input_shardings
    out = []
    for sizes, names in HOST_MESHES:
        tm = _tmesh(sizes, names)
        cases = []
        for arch in ("llama3.2-3b", "mixtral-8x7b", "zamba2-7b"):
            cfg = tget_config(arch).smoke()
            for mode in ("train", "decode"):
                shape = ShapeConfig(mode, 16, 8, mode)
                specs = tspecs.input_specs(cfg, shape)
                flat_specs = _spec_flat(input_shardings(specs, shape, tm))
                for path, leaf in _tflat(specs).items():
                    cases.append((tuple(leaf.shape), flat_specs[path]))
        out.append((sizes, names, sorted(set(cases), key=str)))
    return out


@pytest.fixture(scope="module")
def host_indices():
    todo = _host_cases()
    res = subprocess.run([sys.executable, "-c", INDICES_SNIPPET],
                         input=json.dumps(todo), capture_output=True,
                         text=True, timeout=600,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr[-3000:]
    return todo, json.loads(res.stdout.strip().splitlines()[-1])


def test_shard_tree_blocks_match_named_sharding_devices(host_indices):
    todo, indices = host_indices
    n_split = 0
    for (sizes, names, cases), per_mesh in zip(todo, indices):
        tm = _tmesh(sizes, names)
        for (shape, spec), per_pos in zip(cases, per_mesh):
            x = torch.arange(math.prod(shape), dtype=torch.int64).view(shape)
            for pos, bounds in per_pos:
                coords = dict(zip(names, pos))
                got = tsharding.shard_leaf(x, spec, tm, coords)
                want = x[tuple(slice(a, b) for a, b in bounds)]
                assert torch.equal(got, want), (sizes, shape, spec, pos)
                n_split += got.numel() < x.numel()
    assert n_split > 0


# the round trip at world 2 on the CPU, in gloo ranks
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _split_leaves(tree, shardings, sizes):
    """(whole bytes, sharded dims) of each leaf that a mesh axis of more
    than one rank splits."""
    flat = _spec_flat(shardings)
    for path, leaf in _tflat(tree).items():
        dims = sum(1 for e in flat[path] if e and sizes[e] > 1)
        if dims:
            yield leaf.numel() * leaf.element_size(), dims


def _round_trip_rank(rank, world, port, out_dir):
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import (collective_formula,
                                           input_shardings)
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.mesh import _mesh, init_world
    from repro_torch.train.step import make_train_state
    torch.set_num_threads(1)
    init_world(rank, world, f"tcp://localhost:{port}", device="cpu")
    out = {}
    try:
        cfg = tget_config("llama3.2-3b").smoke()
        gen = torch.Generator().manual_seed(0)
        state = make_train_state(gen, cfg, cfg.lite(), device="cpu")
        # the AdamW state made non-zero, so that its blocks differ
        for leaf in _tflat(state["opt"]).values():
            if leaf.dim():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
        for sizes in ((1, world), (world, 1)):
            mesh = _mesh(sizes, ("data", "model"))
            key = "x".join(map(str, sizes))
            shape = ShapeConfig("train", 16, 2 * world, "train")
            specs = {"state": state, "batch": {}}
            shardings = input_shardings(specs, shape, mesh)
            local = tsharding.shard_tree(specs, shardings, mesh)
            with collective_stats() as stats:
                back = tsharding.gather_tree(local, shardings, mesh)
            out[f"{key}_bitwise"] = all(
                torch.equal(a, b) and a.dtype == b.dtype
                for a, b in zip(_tflat(specs).values(),
                                _tflat(back).values()))
            out[f"{key}_bytes"] = sum(
                t.numel() * t.element_size() for t in _tflat(local).values())
            out[f"{key}_spec_bytes"] = tsharding.tree_bytes(specs, shardings,
                                                            mesh)
            split = list(_split_leaves(specs, shardings,
                                       dict(zip(("data", "model"), sizes))))
            out[f"{key}_gathers"] = stats["all-gather"]
            out[f"{key}_expected"] = {"count": sum(d for _, d in split),
                                      "bytes": sum(b for b, _ in split)}
            # the params alone, against the dry run's formula
            p_specs = {"params": state["params"], "batch": {}}
            p_sh = {"params": shardings["state"]["params"], "batch": {}}
            with collective_stats() as stats:
                tsharding.gather_tree(
                    tsharding.shard_tree(p_specs, p_sh, mesh), p_sh, mesh)
            out[f"{key}_param_gathers"] = stats["all-gather"]
            out[f"{key}_formula"] = collective_formula(
                p_specs, p_sh, ShapeConfig("prefill", 16, 2 * world,
                                           "prefill"), mesh)["all-gather"]
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    import torch.multiprocessing as mp
    out_dir = tmp_path_factory.mktemp("round_trip")
    mp.spawn(_round_trip_rank, args=(2, _free_port(), str(out_dir)),
             nprocs=2, join=True)
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_shard_gather_round_trip_bitwise_at_world_2(round_trip, mesh):
    for rank in round_trip:
        assert rank[f"{mesh}_bitwise"]
        assert rank[f"{mesh}_bytes"] == rank[f"{mesh}_spec_bytes"]
        assert rank[f"{mesh}_gathers"] == rank[f"{mesh}_expected"]
        assert rank[f"{mesh}_gathers"]["count"] > 0
        assert rank[f"{mesh}_param_gathers"] == rank[f"{mesh}_formula"]


# validate.py
@pytest.mark.parametrize("model_axis", [16, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_validate_check_matches_reference(arch, model_axis):
    for shape_name in INPUT_SHAPES:
        assert tvalidate.check(arch, shape_name, model_axis) == \
            jvalidate.check(arch, shape_name, model_axis)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_hbm_train_matches_reference(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for shape in INPUT_SHAPES.values():
        for n_chips, mb in ((256, 4), (512, 4), (8, 0), (16, 1)):
            want = jvalidate.analytic_hbm_train(jcfg, jcfg.lite(), shape,
                                                n_chips, mb)
            got = tvalidate.analytic_hbm_train(tcfg, tcfg.lite(), shape,
                                               n_chips, mb)
            assert got == pytest.approx(want, rel=1e-12)


def test_validate_main_runs_at_the_node_axis(capsys):
    tvalidate.main([])
    out = capsys.readouterr().out
    assert "(model axis 8)" in out and "combos" in out
