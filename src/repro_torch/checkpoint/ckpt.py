"""Checkpointing: tree -> flat npz + json structure, in the reference's
on-disk format, so that a checkpoint written by either package restores in
the other.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars. One checkpoint is two files sharing a path prefix:

  <path>.npz   every leaf as an array, keyed by its path: the dict keys and
               list indices above it joined by "/" (jax.tree_util's keys;
               the archive lists them in its order, dict keys sorted)
  <path>.json  {"step": int, "leaves": {key: dtype name}}

npz has no bfloat16, so a bf16 leaf is stored as its uint16 view with the
dtype name "bfloat16", bit for bit.

Two restore APIs:

* ``load_checkpoint(path, like)`` — restore into the structure of `like`
  (leaf keys must match what was saved; a mismatch raises a KeyError
  naming the missing/extra leaves).
* ``load_checkpoint_flat(path)`` — the raw flat ``{path-key: tensor}``
  mapping, no structure required. Callers that own variable-shaped state
  (the parameter service's PPO buffers, EF residuals, open tickets) use
  this and rebuild their trees from their own key scheme.

Both return tensors on `device` (CUDA when None), in the saved dtypes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_paths_sorted


def _flatten(tree) -> Dict[str, Any]:
    """{key: leaf} with the reference's `_flatten` keys, in its order."""
    return dict(tree_paths_sorted(tree))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array npz stores, its dtype name in the json meta)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(path, tree, step: int = 0):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, meta = {}, {"step": step, "leaves": {}}
    for k, v in _flatten(tree).items():
        arrays[k], meta["leaves"][k] = _to_numpy(v)
    np.savez(str(path) + ".npz", **arrays)
    Path(str(path) + ".json").write_text(json.dumps(meta))


def _check_keys(path, want, have, want_name: str, have_name: str):
    """Raise a KeyError naming the leaves on which two key sets disagree."""
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if not missing and not extra:
        return

    def clip(keys):
        shown = ", ".join(keys[:6])
        return shown + (f", ... ({len(keys) - 6} more)" if len(keys) > 6
                        else "")

    parts = []
    if missing:
        parts.append(f"{len(missing)} {want_name} leaves absent from the "
                     f"{have_name}: [{clip(missing)}]")
    if extra:
        parts.append(f"{len(extra)} {have_name} leaves not in the "
                     f"{want_name}: [{clip(extra)}]")
    raise KeyError(f"checkpoint {path!s} structure mismatch — "
                   + "; ".join(parts))


def _read(path):
    meta = json.loads(Path(str(path) + ".json").read_text())
    data = np.load(str(path) + ".npz")
    # the json meta and the npz are written together; disagreement means a
    # torn/corrupted checkpoint and deserves a loud, named failure
    try:
        _check_keys(path, meta["leaves"], data.files, "meta", "npz")
    except KeyError:
        data.close()
        raise
    return meta, data


def _undo_view(arr: np.ndarray, dtype_name: str,
               device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _rebuild(like, leaf_at, prefix: str = ""):
    """`like`'s structure (its dict order, lists, tuples and None nodes)
    with each leaf replaced by leaf_at(its key)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_at, join(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf_at, join(i))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaf_at(prefix)


def load_checkpoint(path, like, device=None) -> Tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors, arrays or
    scalars), as tensors on `device` (CUDA when None).

    The flattened leaf keys of `like` must match the checkpoint exactly;
    otherwise a KeyError names the missing/extra leaves instead of failing
    on a bare npz lookup deep in the restore loop.
    """
    device = resolve_device(device)
    meta, data = _read(path)
    with data:
        _check_keys(path, _flatten(like), data.files, "`like`",
                    "checkpoint")
        tree = _rebuild(like, lambda k: _undo_view(data[k],
                                                   meta["leaves"][k], device))
    return tree, meta["step"]


def load_checkpoint_flat(path, device=None) -> Tuple[Dict[str, Any], int]:
    """Load every saved leaf as ``{path-key: tensor}`` on `device` (CUDA
    when None) without a `like` structure (bf16 leaves are un-viewed back
    to bfloat16)."""
    device = resolve_device(device)
    meta, data = _read(path)
    with data:
        return ({k: _undo_view(data[k], meta["leaves"][k], device)
                 for k in data.files}, meta["step"])
