"""xlstm-1.3b — sLSTM + mLSTM blocks (xLSTM[7:1]). [arXiv:2405.04517]

Attention-free: mLSTM uses a chunkwise-parallel (matmul) form on TPU;
every 8th block is a recurrent sLSTM (lax.scan). d_ff=0 — xLSTM blocks
carry their own up/down projections (factor 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8,
    norm="layernorm", act="gelu", tie_embeddings=True,
    source="arXiv:2405.04517",
)
