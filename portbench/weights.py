"""The benchmark's weights, made from the seed on the device: the same
numbers for the program and for the reference.

A model's weights come in groups: "io" (the final norm, the token table and
the output head) and "layer<l>" for each block. A group is made by one
generator seeded from (seed, model, group), with one draw of N(0, 1) values
a storage dtype for all of its random leaves, sliced and scaled in place:
1/sqrt(fan_in) for a projection, 0.02 for the token table, and ones for a
norm's scale. So the reference can make any one group again without
holding the rest.

Leaves are named flat, as `reference.model` reads them; `PROGRAM_PATH` maps
each name to its place in the program's parameter tree.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

#: flat leaf name -> its path in the program's block or io tree
PROGRAM_PATH = {
    "norm1.scale": ("norm1", "scale"), "norm2.scale": ("norm2", "scale"),
    "wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
    "wo": ("attn", "wo"),
    "w_up": ("mlp", "w_up"), "w_gate": ("mlp", "w_gate"),
    "w_down": ("mlp", "w_down"),
    "router": ("moe", "router"), "e_up": ("moe", "w_up"),
    "e_gate": ("moe", "w_gate"), "e_down": ("moe", "w_down"),
    "norm_f.scale": ("norm_f", "scale"), "embed": ("embed",),
    "head": ("head",),
}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def layer_leaves(spec) -> List[Tuple[str, tuple, torch.dtype, float]]:
    """(name, shape, dtype, scale) of one block; scale 0 marks a norm's
    ones."""
    d, H, KV, hd = spec.d, spec.heads, spec.kv_heads, spec.head_dim
    dt = _dtype(spec.dtype)
    out = [("norm1.scale", (d,), dt, 0.0),
           ("wq", (d, H * hd), dt, 1 / math.sqrt(d)),
           ("wk", (d, KV * hd), dt, 1 / math.sqrt(d)),
           ("wv", (d, KV * hd), dt, 1 / math.sqrt(d)),
           ("wo", (H * hd, d), dt, 1 / math.sqrt(H * hd)),
           ("norm2.scale", (d,), dt, 0.0)]
    if spec.experts:
        E, ff = spec.experts, spec.moe_ff
        out += [("router", (d, E), torch.float32, 1 / math.sqrt(d)),
                ("e_up", (E, d, ff), dt, 1 / math.sqrt(d)),
                ("e_gate", (E, d, ff), dt, 1 / math.sqrt(d)),
                ("e_down", (E, ff, d), dt, 1 / math.sqrt(ff))]
    else:
        out += [("w_up", (d, spec.ff), dt, 1 / math.sqrt(d)),
                ("w_gate", (d, spec.ff), dt, 1 / math.sqrt(d)),
                ("w_down", (spec.ff, d), dt, 1 / math.sqrt(spec.ff))]
    return out


def io_leaves(spec) -> List[Tuple[str, tuple, torch.dtype, float]]:
    dt = _dtype(spec.dtype)
    out = [("norm_f.scale", (spec.d,), dt, 0.0),
           ("embed", (spec.vocab, spec.d), dt, 0.02)]
    if not spec.tie:
        out.append(("head", (spec.d, spec.vocab), dt, 1 / math.sqrt(spec.d)))
    return out


def group_seed(seed: int, model: str, group: str) -> int:
    h = hashlib.blake2b(f"{seed}:{model}:{group}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def make_group(spec, seed: int, model: str, group: str,
               device) -> Dict[str, torch.Tensor]:
    """The leaves of `group` ("io" or "layer<l>") of `model` in their
    storage dtypes, on `device`."""
    leaves = io_leaves(spec) if group == "io" else layer_leaves(spec)
    gen = torch.Generator(device).manual_seed(group_seed(seed, model, group))
    out: Dict[str, torch.Tensor] = {}
    for dt in sorted({l[2] for l in leaves if l[3]}, key=str):
        mine = [l for l in leaves if l[3] and l[2] == dt]
        n = sum(math.prod(l[1]) for l in mine)
        flat = torch.randn(n, generator=gen, device=device, dtype=dt)
        at = 0
        for name, shape, _, scale in mine:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(scale)
            at += size
    for name, shape, dt, scale in leaves:
        if not scale:
            out[name] = torch.ones(shape, dtype=dt, device=device)
    return out


def program_tree(spec, seed: int, model: str, device) -> dict:
    """The program's parameter tree {"io", "blocks"} of `model`, its blocks
    stacked on a leading (layers, ...) axis, filled group by group."""
    io = {}
    for name, t in make_group(spec, seed, model, "io", device).items():
        _put(io, PROGRAM_PATH[name], t)
    blocks: dict = {}
    for name, shape, dt, _ in layer_leaves(spec):
        _put(blocks, PROGRAM_PATH[name],
             torch.empty((spec.layers,) + shape, dtype=dt, device=device))
    for l in range(spec.layers):
        g = make_group(spec, seed, model, f"layer{l}", device)
        for name, t in g.items():
            _get(blocks, PROGRAM_PATH[name])[l].copy_(t)
        del g
    return {"io": io, "blocks": blocks}


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def program_leaf(tree: dict, group: str, name: str) -> torch.Tensor:
    """Leaf `name` of `group` in a program tree made by `program_tree` (a
    block's slice of its stacked leaf)."""
    if group == "io":
        return _get(tree["io"], PROGRAM_PATH[name])
    return _get(tree["blocks"], PROGRAM_PATH[name])[int(group[5:])]
