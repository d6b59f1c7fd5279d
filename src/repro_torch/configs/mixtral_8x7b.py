"""mixtral-8x7b — sparse MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088] — SWA window 4096 makes long_500k decode natively feasible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab_size=32000,
    n_experts=8, top_k=2, moe_d_ff=14336,
    sliding_window=4096,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    source="arXiv:2401.04088",
)
