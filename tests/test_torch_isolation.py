"""The port stands alone: every repro_torch module imports in a process where
`jax` and the reference package `repro` cannot be imported, and its entry
points never fall back to the CPU on their own."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_BLOCK_AND_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _BLOCK_AND_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the package, its subpackages and their modules: well over a dozen
    assert int(out.stdout.split()[-1]) >= 20


def test_server_defaults_to_cuda_and_never_falls_back(monkeypatch):
    from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
    env = FLEnvironment(FLSimConfig(n_train=100, n_test=20, n_clients=4,
                                    k_per_round=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HAPFLServer(env)
    with pytest.raises(RuntimeError, match="CUDA"):
        HAPFLServer(env, device="cuda")
    assert HAPFLServer(env, device="cpu").device == torch.device("cpu")


def _default_device_cases(ckpt):
    """Each public constructor of the port, called with its device left at
    the default (`ckpt`: a path prefix for a checkpoint)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.allocation import ModelAllocator
    from repro_torch.core.nested import zeros_params
    from repro_torch.core.intensity import IntensityAllocator
    from repro_torch.core.ppo import PPOAgent, PPOConfig
    from repro_torch.fl import (BaselineRunner, BatchedClientEngine,
                                FLEnvironment, FLSimConfig)
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    from repro_torch.models.cnn import cnn_pool, init_cnn
    from repro_torch.models.moe import init_moe
    from repro_torch.launch.serve import build_service
    from repro_torch.serve import ServeEngine
    gen = torch.Generator().manual_seed(0)

    def load_saved():
        like = {"w": torch.zeros(2, 2)}
        save_checkpoint(ckpt, like)
        return load_checkpoint(ckpt, like)
    smoke = get_config("llama3.2-3b").smoke()
    moe = get_config("qwen3-moe-30b-a3b").smoke()
    return {
        "engine": lambda: BatchedClientEngine(FLEnvironment(FLSimConfig(
            n_train=100, n_test=20, n_clients=4, k_per_round=2))),
        "ppo_agent": lambda: PPOAgent(
            PPOConfig(state_dim=4, kind="gaussian_simplex"), gen),
        "model_allocator": lambda: ModelAllocator(4, ["small", "large"], gen),
        "intensity_allocator": lambda: IntensityAllocator(4, gen),
        "init_cnn": lambda: init_cnn(gen, cnn_pool("mnist")["lite"]),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros((2, 2), np.float32)}),
        "init_model": lambda: init_model(gen, smoke),
        "serve_engine": lambda: ServeEngine(
            smoke, init_model(gen, smoke, device="cpu")),
        "baseline_runner": lambda: BaselineRunner(FLEnvironment(FLSimConfig(
            n_train=100, n_test=20, n_clients=4, k_per_round=2)), "fedprox"),
        "zeros_params": lambda: zeros_params(cnn_pool("mnist")["small"]),
        "build_service": lambda: build_service(
            4, 2, "async", "identity", 0, min_deadline=1.0),
        "load_checkpoint": load_saved,
        "init_model_moe": lambda: init_model(gen, moe),
        "serve_engine_moe": lambda: ServeEngine(
            moe, init_model(gen, moe, device="cpu")),
        "init_moe": lambda: init_moe(gen, moe),
    }


@pytest.mark.parametrize("name", ["engine", "ppo_agent", "model_allocator",
                                  "intensity_allocator", "init_cnn",
                                  "params_from_numpy", "init_model",
                                  "serve_engine", "baseline_runner",
                                  "zeros_params", "build_service",
                                  "load_checkpoint", "init_model_moe",
                                  "serve_engine_moe", "init_moe"])
def test_constructors_default_to_cuda(monkeypatch, tmp_path, name):
    """Left at its default, every entry point asks for the card, and
    without one it raises instead of running on the CPU."""
    make = _default_device_cases(tmp_path / "ck")[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
