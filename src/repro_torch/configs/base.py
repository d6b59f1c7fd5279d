"""Model / shape / run configuration for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``. HAPFL's
heterogeneous model pool is derived via ``size_variants()`` (the paper's
delta model categories) and ``lite()`` (the paper's LiteModel).

A copy of ``repro.configs.base`` with ``torch`` dtypes in place of ``jnp``
ones, so that a config of either package compares field by field with the
other's (``asdict()`` names the dtype the same way in both). ``remat`` runs
each block under ``torch.utils.checkpoint`` when autograd records, as the
reference wraps it in ``jax.checkpoint`` (``models/transformer.py``).
``scan_layers`` is kept as a field but means nothing in the port, which
loops over layers in Python.

The port adds fields of its own (`PORT_DEFAULTS`) for Zamba2 as published
(``family="zamba2"``, `models/zamba2.py`) and for serving; ``asdict()``
leaves each out while it holds its default, so every config the reference
has compares with the reference's field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str     # dense | moe | ssm | hybrid | zamba2 | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0               # mamba2 state size
    ssm_conv: int = 4
    slstm_every: int = 0             # xlstm: every Nth block is an sLSTM block
    shared_attn_every: int = 0       # zamba2: shared attn block period
    # --- attention ---
    sliding_window: int = 0          # 0 = full causal attention
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE section split of head_dim/2
    # --- io ---
    n_codebooks: int = 0             # musicgen EnCodec codebooks
    input_mode: str = "tokens"       # tokens | embeddings (vlm stub frontend)
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln (olmo)
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    # --- provenance ---
    source: str = ""
    # --- the port's own (PORT_DEFAULTS) ---
    # family "zamba2" is Zamba2 as published (`models/zamba2.py`): each
    # shared block reads RMSNorm(concat(h, embedding)) at width 2 d, scales
    # its scores by (hd / 2)^-0.5 and has a gated exact-gelu MLP, and its
    # output, mapped by a d x d linear, joins the input of a Mamba2 layer;
    # each Mamba2 layer ends in a gated RMSNorm over `mamba_groups` groups
    mamba_groups: int = 1            # Mamba2 B/C groups, heads split evenly
    shared_blocks: int = 1           # zamba2: shared blocks, taken in turn
    hybrid_layer_ids: Tuple[int, ...] = ()  # zamba2: layers a block joins
    shared_mlp_adapter_rank: int = 0  # zamba2: LoRA rank on gate_up, each call
    dt_min: float = 0.0              # Mamba2: dt clamped below (0: no clamp)
    carry_prompt_state: bool = False  # serve: prompt state goes to decode

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def block_kind(self) -> str:
        if self.family == "ssm":
            return "xlstm" if self.slstm_every else "mamba2"
        if self.family in ("hybrid", "zamba2"):
            return "mamba2"
        return "attention"

    @property
    def subquadratic(self) -> bool:
        """Whether long-context (500k) decode is feasible for this config."""
        return (self.family in ("ssm", "hybrid", "zamba2")
                or self.sliding_window > 0)

    # ------------------------------------------------------------------ #
    def num_params(self) -> int:
        """Analytic parameter count (used by the latency model & rooflines)."""
        if self.family == "zamba2":
            return self._zamba2_params()
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.resolved_head_dim
        emb = self.vocab_size * d * (self.n_codebooks or 1)
        unemb = 0 if self.tie_embeddings else self.vocab_size * d * (self.n_codebooks or 1)
        per_layer = 0
        if self.block_kind == "attention" or self.family == "hybrid":
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        else:
            attn = 0
        if self.block_kind == "attention":
            if self.is_moe:
                mlp = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            else:
                mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            per_layer = attn + mlp
        elif self.block_kind == "mamba2":
            dn = self.ssm_state
            inner = 2 * d
            per_layer = d * (2 * inner + 2 * dn) + inner * d + inner  # in/out proj + B,C + dt
        elif self.block_kind == "xlstm":
            inner = 2 * d
            per_layer = d * inner * 2 + inner * d + 3 * d * hd * max(h, 1)
        total = emb + unemb + self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared attention+MLP block reused every `shared_attn_every` layers
            total += d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * self.d_ff
        return int(total)

    def _zamba2_params(self) -> int:
        """Every leaf of `models/zamba2.py`'s tree, norms and biases too."""
        d, h, kv, hd = (self.d_model, self.n_heads, self.n_kv_heads,
                        self.resolved_head_dim)
        inner, n, G = 2 * d, self.ssm_state, self.mamba_groups
        H = inner // 64
        conv = inner + 2 * G * n
        mamba = (d * (inner + conv + H) + self.ssm_conv * conv + conv
                 + 3 * H + inner + inner * d + d)
        block = (2 * d + 2 * d * (h + 2 * kv) * hd + h * hd * d + d
                 + 3 * d * self.d_ff)
        calls = len(self.hybrid_layer_ids)
        r = self.shared_mlp_adapter_rank
        per_call = r * (d + 2 * self.d_ff) + d * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + d + self.n_layers * mamba
                   + self.shared_blocks * block + calls * per_call)

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.num_params()
        d = self.d_model
        dense_like = self.num_params() - self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        return int(dense_like + self.n_layers * self.top_k * 3 * d * self.moe_d_ff)

    # ------------------------------------------------------------------ #
    # HAPFL model pool: the paper's delta size categories + LiteModel.
    # ------------------------------------------------------------------ #
    def scaled(self, depth: float, width: float, tag: str) -> "ModelConfig":
        """Same-family variant with scaled depth/width (head_dim preserved)."""
        hd = self.resolved_head_dim
        n_heads = max(1, int(round(self.n_heads * width)))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        d_model = n_heads * hd
        rounding = max(hd, 128)
        d_ff = max(rounding, int(round(self.d_ff * width / rounding)) * rounding) if self.d_ff else 0
        moe_ff = max(128, int(round(self.moe_d_ff * width / 128)) * 128) if self.moe_d_ff else 0
        return replace(
            self, name=f"{self.name}-{tag}",
            n_layers=max(1, int(round(self.n_layers * depth))),
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            d_ff=d_ff, moe_d_ff=moe_ff, head_dim=hd,
        )

    def lite(self) -> "ModelConfig":
        """The paper's LiteModel: small, family-consistent, same vocab/io."""
        if self.input_mode == "embeddings":
            # VLM: the LiteModel consumes the SAME precomputed patch
            # embeddings, so its width must match the parent d_model.
            return replace(self, name=f"{self.name}-lite", n_layers=2,
                           d_ff=512, n_experts=0, top_k=0, moe_d_ff=0,
                           shared_attn_every=0)
        hd = min(self.resolved_head_dim, 64)
        cfg = replace(
            self, name=f"{self.name}-lite", n_layers=2,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 4),
            d_model=4 * hd, head_dim=hd,
            d_ff=512 if self.d_ff else 0,
            n_experts=0, top_k=0, moe_d_ff=0,
            shared_attn_every=0,
        )
        if cfg.family == "moe":
            cfg = replace(cfg, family="dense", d_ff=512)
        return cfg

    def size_variants(self) -> Dict[str, "ModelConfig"]:
        """delta = 3 model categories (paper §V.C.4 uses small/medium/large)."""
        return {
            "small": self.scaled(0.5, 0.5, "small"),
            "medium": self.scaled(0.75, 0.75, "medium"),
            "large": replace(self, name=f"{self.name}-large"),
        }

    def smoke(self) -> "ModelConfig":
        """Reduced variant for CPU smoke tests: 2 layers, d_model<=512, <=4 experts."""
        hd = min(self.resolved_head_dim, 64)
        n_heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, n_heads)
        cfg = replace(
            self, name=f"{self.name}-smoke", n_layers=2,
            n_heads=n_heads, n_kv_heads=kv, d_model=n_heads * hd, head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            dtype=torch.float32, remat=False, scan_layers=False,
        )
        if cfg.mrope_sections:
            half = hd // 2
            cfg = replace(cfg, mrope_sections=(half - 2 * (half // 4), half // 4, half // 4))
        return cfg

    def long_ctx_variant(self) -> "ModelConfig":
        """Sliding-window variant enabling long_500k decode for dense archs.

        Explicitly NOT the faithful config — labeled `-swa` everywhere.
        """
        if self.subquadratic:
            return self
        return replace(self, name=f"{self.name}-swa", sliding_window=8192)

    def asdict(self):
        """The fields by name, the dtype's name for the dtype; each of the
        port's own fields (`PORT_DEFAULTS`) only where it differs from its
        default."""
        d = dataclasses.asdict(self)
        d["dtype"] = str(self.dtype).removeprefix("torch.")
        for k, v in PORT_DEFAULTS.items():
            if d[k] == v:
                del d[k]
        return d


#: the port's own fields, which the reference's config does not have, and
#: their defaults
PORT_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ModelConfig)
                 if f.name in ("mamba_groups", "shared_blocks",
                               "hybrid_layer_ids", "shared_mlp_adapter_rank",
                               "dt_min", "carry_prompt_state")}


# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
