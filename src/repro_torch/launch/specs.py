"""Meta-device input stand-ins for every (arch x shape) dry-run combination.

Counterpart of ``repro.launch.specs``. Where the reference makes
``jax.ShapeDtypeStruct`` trees through ``jax.eval_shape``, the port makes
tensors on the meta device: they carry shape, dtype and strides and no
data, so mixtral-8x7b's 93.4 GB of bf16 weights cost a dict of shapes. They
come from the port's own constructors (`init_model`, `make_train_state`,
`make_decode_cache`) with ``device="meta"``, so they are the trees the
port's train, prefill and decode steps consume, and those steps run on
them (`launch.dryrun`).

Dtypes follow the port's convention where it differs from the reference's
int32: tokens and labels are int64 (`models.api.dummy_batch`, the serving
engine's token buffer) and the decode position is a 0-d int64 tensor (the
engine's, which a CUDA graph replays); M-RoPE positions stay int32.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.api import init_model, make_decode_cache
from repro_torch.train.step import TrainStepConfig, make_train_state

META = torch.device("meta")
TOKEN_DTYPE = torch.int64
POSITION_DTYPE = torch.int32


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = _empty((batch, seq, cfg.d_model), cfg.dtype)
        out["positions"] = _empty((3, batch, seq), POSITION_DTYPE)
    elif cfg.n_codebooks:
        out["tokens"] = _empty((batch, seq, cfg.n_codebooks), TOKEN_DTYPE)
    else:
        out["tokens"] = _empty((batch, seq), TOKEN_DTYPE)
    if with_labels:
        shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks
                 else (batch, seq))
        out["labels"] = _empty(shape, TOKEN_DTYPE)
    return out


def params_specs(cfg: ModelConfig):
    return init_model(None, cfg, META)


def train_state_specs(cfg_local: ModelConfig, cfg_lite: ModelConfig,
                      tcfg: TrainStepConfig = TrainStepConfig()):
    return make_train_state(None, cfg_local, cfg_lite, tcfg, META)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache; under a current length-sharded mesh
    (`launch.axes.use_axis_rules`) this rank's slice of it, as
    `make_decode_cache` makes it."""
    return make_decode_cache(cfg, batch, max_len, META)


def input_specs(cfg_local: ModelConfig, shape: ShapeConfig,
                cfg_lite: ModelConfig = None,
                tcfg: TrainStepConfig = TrainStepConfig()):
    """Everything the step consumes, as meta tensors.

    train  -> {state, batch}
    prefill-> {params, batch}
    decode -> {params, batch(1 token), cache, cache_index}
    """
    if shape.mode == "train":
        cfg_lite = cfg_lite or cfg_local.lite()
        return {
            "state": train_state_specs(cfg_local, cfg_lite, tcfg),
            "batch": batch_specs(cfg_local, shape.global_batch, shape.seq_len),
        }
    if shape.mode == "prefill":
        return {
            "params": params_specs(cfg_local),
            "batch": batch_specs(cfg_local, shape.global_batch, shape.seq_len,
                                 with_labels=False),
        }
    return {
        "params": params_specs(cfg_local),
        "batch": batch_specs(cfg_local, shape.global_batch, 1,
                             with_labels=False),
        "cache": cache_specs(cfg_local, shape.global_batch, shape.seq_len),
        "cache_index": _empty((), TOKEN_DTYPE),
    }
