"""Architecture registry — the assigned 10-arch pool (+ the paper's CNN
pool), and the configurations served as published (`_SERVED`)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
}

ARCH_IDS: List[str] = list(_MODULES)

#: served as published, outside the pool (the reference has no such config)
_SERVED = {
    "zamba2-7b-instruct": "repro_torch.configs.zamba2_7b_instruct",
}


def get_config(name: str) -> ModelConfig:
    module = _MODULES.get(name) or _SERVED.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{[*_MODULES, *_SERVED]}")
    return importlib.import_module(module).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
