"""olmo-1b — dense decoder with non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", act="silu", tie_embeddings=True,
    source="arXiv:2402.00838",
)
