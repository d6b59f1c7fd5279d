"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] MusicGen: Simple and Controllable Music Generation.
Backbone only; the EnCodec tokenizer / conv codec is a stub frontend —
``input_specs()`` provides the (B, S, n_q) token grid. 4 codebooks with a
delay-pattern interleave; embeddings are summed over codebooks and each
codebook has its own output head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    n_codebooks=4,
    norm="layernorm", act="gelu",
    source="arXiv:2306.05284",
)
