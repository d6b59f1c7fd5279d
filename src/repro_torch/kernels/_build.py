"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``).
The library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. `build` starts one
``nvcc`` per source, all together, and keeps each one's ``-Xptxas -v``
register and spill report in `reports`. A failed build raises: there is no
fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"kd_loss": "kd_loss.cu", "rmsnorm": "rmsnorm.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "adamw": "adamw.cu", "decode_attention": "decode_attention.cu"}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the `dtype` argument every kernel's C entry point takes
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: name -> nvcc's output (the ptxas register/spill report) of this process's
#: build; empty for a library that was already on disk
reports: Dict[str, str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc each, all started together. Returns build seconds per source
    compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = {}
    for name in (SOURCES if names is None else names):
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)      # atomic: a concurrent build never sees half
        reports[name] = log
        seconds[name] = time.perf_counter() - t0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
