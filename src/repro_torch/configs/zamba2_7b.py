"""zamba2-7b — hybrid: Mamba2 backbone + a shared attention block. [arXiv:2411.15242]

81 Mamba2 (SSD) layers; one shared (attention + MLP) block whose weights are
reused every 6 layers (13 invocations), zamba-style.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, shared_attn_every=6,
    norm="rmsnorm", act="silu",
    source="arXiv:2411.15242",
)
