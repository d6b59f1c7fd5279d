"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  kd_loss          — fused CE + bidirectional KL (paper Eqs. 33-34): forward
                     and backward under one autograd.Function, and
                     kd_loss_grad, the HAPFL step's loss means and logit
                     gradients in one launch
  rmsnorm          — row RMSNorm, alone and fused with the residual add
                     before it (the transformer's norms), with backward
                     kernels under autograd Functions
  flash_attention  — causal / sliding-window attention with grouped KV heads
                     (the transformer's training and prefill attention);
                     the forward keeps the rows' log-sum-exp for the
                     backward kernels (csrc/flash_attention_bwd.cu)
  decode_attention — one-token attention over a KV cache, read in place over
                     the filled slots (the serving decode step)
  adamw            — the optimizer's gradient global norm and in-place AdamW
                     step, each one pass over every leaf of a tree
  ops              — the model's and the HAPFL step's entry points
  ref              — plain PyTorch versions (the CPU path and the on-card oracle)
  cost             — each kernel's bytes and operations by formula, its bound
                     on the card, and the dry run's tally of the kernels
                     met on meta tensors
  _build           — builds csrc/*.cu with nvcc at first use, loads them via ctypes
"""
