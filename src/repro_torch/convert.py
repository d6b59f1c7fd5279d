"""Carry parameter trees across the numpy boundary.

The CNN pool's and the PPO agents' params are nested dicts and lists of
arrays. `params_from_numpy` turns such a tree of numpy arrays (for example
``jax.device_get`` of the reference's params) into tensors on `device`
(CUDA when None); `params_to_numpy` turns a tree of tensors back into numpy
arrays. Layouts are kept as they are: HWIO conv kernels, (in, out) dense
weights, the transformer's block params stacked on a leading layer axis.

bfloat16 crosses without ``ml_dtypes``: a numpy array whose dtype is named
"bfloat16" (what ``jax.device_get`` gives for a bf16 array) is viewed as
uint16 and then as ``torch.bfloat16``, bit for bit. Going the other way,
numpy has no bfloat16 of its own, so `params_to_numpy` returns a bf16
tensor as float32, which holds every bf16 value exactly; a tree that comes
back through `params_from_numpy` therefore arrives as float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None):
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a).to(device), tree)


def params_to_numpy(tree):
    def to_numpy(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(to_numpy, tree)
