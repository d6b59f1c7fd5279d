"""qwen2-vl-2b — VLM language backbone with M-RoPE. [arXiv:2409.12191]

The ViT/SigLIP vision tower + projector is a stub frontend per the carve-out:
``input_specs()`` supplies precomputed patch embeddings (B, S, d_model) plus
M-RoPE (temporal, height, width) position ids of shape (3, B, S).
head_dim=128 -> rotary half=64 split (16, 24, 24).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    input_mode="embeddings",
    norm="rmsnorm", act="silu", rope_theta=1e6,
    source="arXiv:2409.12191",
)
