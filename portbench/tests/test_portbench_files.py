"""The benchmark's files: BENCHMARK.json within its contract, every cell,
configuration, job and metric found by name, a new cell and metric added as
files alone, and no module of the benchmark importing JAX or the JAX
package."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
HERE = harness.HERE
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_load_by_name(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert NAME.match(cell) and NAME.match(entry["config"])
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    spec = harness.load_json("workloads", cell)
    assert spec["config"] == entry["config"] and spec["why"] == entry["why"]
    assert spec["chips"] == entry["chips"]
    harness.load_json("configs", spec["config"])
    assert callable(harness.load_module("jobs", spec["job"]).make)
    e2e, per_layer = harness.cell_metrics(MAN, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in {e["name"] for e in e2e}
    assert spec["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_readers_load_by_name(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)
    assert mod.read({"job": "nothing"}) is None


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_files(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    cj = harness.load_json("configs", config)
    assert cj["name"] == config and cj["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(cj["published"])
    assert any(w["config"] == config for w in MAN["workloads"])


def test_lite_models_match_the_program():
    """A configuration's "lite" is the program's LiteModel of it."""
    from portbench.reference.model import from_config
    for c in MAN["configs"]:
        cj = harness.load_json("configs", c["name"])
        lite = harness.program_config(from_config(cj, lite=True), "x")
        want = harness.program_config(from_config(cj), "x").lite()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "head_dim", "n_experts", "vocab_size", "mrope_sections",
                  "input_mode"):
            assert getattr(lite, f) == getattr(want, f), (c["name"], f)


def test_new_cell_and_metric_as_files_alone(tmp_path):
    """A later change adds a cell and a metric as files: the loaders find
    them by name with no other edit."""
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    cell = dict(harness.load_json("workloads", "qwen3moe-serve-b32"),
                name="extra-cell")
    (tmp_path / "workloads" / "extra-cell.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "extra_ms.serve.py").write_text(
        "def read(rec):\n    return rec.get('x')\n")
    assert harness.load_json("workloads", "extra-cell",
                             tmp_path)["name"] == "extra-cell"
    mod = harness.load_module("metrics", "extra_ms.serve", tmp_path)
    assert mod.read({"x": 2.5}) == 2.5
    man = {"end_to_end": MAN["end_to_end"],
           "per_layer": MAN["per_layer"] + [
               {"name": "extra_ms.serve", "workloads": ["extra-cell"]}]}
    _, per_layer = harness.cell_metrics(man, "extra-cell")
    assert [m["name"] for m in per_layer] == ["extra_ms.serve"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    """Compared by whole top-level names: repro_torch passes, repro does
    not."""
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path
    for name in ("weights.py", "traffic.py", "cost.py"):
        assert "repro_torch" not in set(_imports(HERE / name)), name


def test_nothing_reads_the_jax_benchmarks():
    """No code string names benchmarks/ or artifacts/ (docstrings may)."""
    for path in SOURCES:
        if "tests" in path.relative_to(HERE).parts:
            continue
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and id(node) not in docs:
                assert "benchmarks" not in node.value, path
                assert "artifacts" not in node.value, path


def test_outside_a_checkout_run_exits_without_a_result(tmp_path, capsys):
    """run.py copied with BENCHMARK.json alone exits non-zero, no result."""
    import shutil
    import subprocess
    import sys
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3moe-serve-b32", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "correct" not in proc.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_on_the_card(cell):
    """A short run of the cell on the card: one result line, correct."""
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
