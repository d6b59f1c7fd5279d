"""Tiny configurations and cells for the benchmark's CPU tests: the cells'
own job, step and limits, with sizes a test run holds."""
from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from portbench import harness


def tiny_vlm(dtype: str = "float32") -> dict:
    return {"name": "tiny-vlm", "num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
            "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "rope_scaling": {"mrope_section": [4, 2, 2]},
            "tie_word_embeddings": True, "torch_dtype": dtype,
            "input_mode": "embeddings",
            "lite": {"num_hidden_layers": 1, "intermediate_size": 32}}


def tiny_moe(dtype: str = "float32") -> dict:
    return {"name": "tiny-moe", "num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128,
            "moe_intermediate_size": 32, "num_experts": 8,
            "num_experts_per_tok": 2, "capacity_factor": 1.25,
            "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "router_aux_loss_coef": 0.001, "tie_word_embeddings": False,
            "torch_dtype": dtype,
            "input_mode": "tokens",
            "lite": {"num_hidden_layers": 1, "hidden_size": 32,
                     "num_attention_heads": 2, "num_key_value_heads": 2,
                     "head_dim": 16, "intermediate_size": 32,
                     "num_experts": 0}}


TINY_TRAFFIC = {
    "qwen2vl-train-b4s2048": {"batch": 2, "seq": 24, "image": [1, 2, 3],
                              "zipf": 1.0},
    "qwen3moe-l4-train-b4s2048": {"batch": 2, "seq": 24, "zipf": 1.0},
    "qwen3moe-serve-b32": {"batch": 4, "prompt": 12, "new_tokens": 5,
                           "max_len": 32, "zipf": 1.0},
}


def tiny_cell(name: str, dtype: str = "float32"):
    """(cell, config): the cell's own file with tiny traffic, and a tiny
    configuration of its family."""
    cell = copy.deepcopy(harness.load_json("workloads", name))
    cell["traffic"] = dict(TINY_TRAFFIC[name])
    cfg = tiny_moe(dtype) if "moe" in name else tiny_vlm(dtype)
    return cell, cfg


def ctx(cell: dict, config: dict, seed: int = 5, seconds: float = 0.3,
        trace: int = 0):
    return SimpleNamespace(torch=torch, device=torch.device("cpu"),
                           seed=seed, seconds=seconds, trace=trace,
                           cell=cell, config=config,
                           since_start=lambda: 0.0)


def e2e_entries():
    return harness.manifest()["end_to_end"]
