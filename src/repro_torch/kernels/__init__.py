"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  kd_loss  — fused CE + bidirectional KL (paper Eqs. 33-34), forward and
             backward, bound by one autograd.Function
  ref      — plain PyTorch versions (the CPU path and the on-card oracle)
  _build   — builds csrc/*.cu with nvcc at first use, loads them via ctypes
"""
