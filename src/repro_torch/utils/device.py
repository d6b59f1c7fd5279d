"""Where the port's tensors live: CUDA unless the caller asks otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, CUDA when None. Asking for CUDA without a card raises; no
    entry point falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device
