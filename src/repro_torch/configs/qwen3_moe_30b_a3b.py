"""qwen3-moe-30b-a3b — fine-grained MoE: 128 experts, top-8, expert d_ff=768.

[hf:Qwen/Qwen3-30B-A3B] head_dim=128 (decoupled from d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, vocab_size=151936,
    head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=768,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
