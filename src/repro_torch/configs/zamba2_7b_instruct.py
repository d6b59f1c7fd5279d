"""zamba2-7b-instruct — Zamba2-7B-Instruct as published.
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json]

81 Mamba2 layers (d 3584, expand 2: 112 heads of 64, d_state 64, conv 4
with bias, B and C in 2 groups, a gated RMSNorm over 2 groups of 3584
before out_proj, dt clamped below at time_step_min 0.001) and 2 shared
blocks taken in turn at the 13 `hybrid_layer_ids`: RMSNorm of the
concatenated (hidden, embedding) stream at width 7168, 32 heads of 224
with full RoPE (theta 1e4) and scores scaled by (224 / 2)^-0.5, then
RMSNorm and a gelu(gate) * up MLP of 14336 with a rank-128 LoRA on
gate_up for each of the 13 calls; a 3584 x 3584 linear maps each call's
output into the input of its Mamba2 layer (`models/zamba2.py`). The head
is tied (the Zamba2Config default). The serve engine carries the prompt's
recurrent state into the decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b-instruct", family="zamba2",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_conv=4, rope_theta=10000.0,
    norm="rmsnorm", act="gelu", tie_embeddings=True,
    mamba_groups=2, shared_blocks=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    shared_mlp_adapter_rank=128, dt_min=0.001, carry_prompt_state=True,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
)
