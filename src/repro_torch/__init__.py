"""PyTorch port of the HAPFL reproduction, for one NVIDIA H100.

Module names mirror ``repro`` (the JAX reference package), so each module's
counterpart is found under the same path. The package imports ``torch`` and
numpy only, never ``jax`` or ``repro``: the numpy-only modules it needs are
kept here as copies. Entry points run on CUDA unless the caller passes
``device="cpu"``; the kernels under ``repro_torch.kernels`` are hand-written
CUDA, and their plain PyTorch versions serve CPU tensors.
"""
__version__ = "0.1.0"
