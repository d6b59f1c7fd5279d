"""Carry parameter trees across the numpy boundary.

The CNN pool's and the PPO agents' params are nested dicts and lists of
arrays. `params_from_numpy` turns such a tree of numpy arrays (for example
``jax.device_get`` of the reference's params) into tensors on `device`
(CUDA when None); `params_to_numpy` turns a tree of tensors back into numpy
arrays. Layouts are kept as they are: HWIO conv kernels, (in, out) dense
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def params_from_numpy(tree, device=None):
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
