"""Cross-size nested model aggregation (HeteroFL-style; DESIGN.md §12).

The CNN pool is width-nested (models/cnn.assert_nested_pool pins it): each
smaller model's conv kernels ``(3, 3, c_in_s, c_out_s)``, conv biases, and
hidden/output matrices are the *leading slices* of the next size up. The one
place leading slices are not enough is the flatten boundary: fc1's input
rows are laid out row-major over the post-conv feature grid ``(H, W, C)``
(row index ``(h*W + w)*C + c``), and both the grid and the channel count
differ across sizes — two models share exactly the rows with
``h < min(H)``, ``w < min(W)``, ``c < min(C)``, at *different* row indices
in each model. `_shared_rows` is that explicit remap.

On top of the slice-index map this module provides

  extract_submodel / embed_submodel — copy the shared region between two
      sizes (both directions of the same partial map; identity when the
      configs match, so same-size round trips are bit-exact passthroughs),
  coverage_mask — which entries of a target-size tree a source size owns,
  nested_aggregate — HeteroFL/FedADP-style cross-size aggregation: every
      entry of every size's global model is averaged over *every* client
      whose model contains it, with Eq. 38 (optionally staleness-discounted)
      weights renormalized over the covering set (DESIGN.md §12). A size
      group with a single client still inherits the whole fleet's updates
      on its shared region. With a single-size pool this reduces — through
      the very same `weighted_aggregate` call — bit-identically to
      `group_aggregate`.

The layouts are the reference's (NHWC, HWIO kernels, fc1 rows in
`flat_grid()` order), so the index maps are its own: `_shared_rows` and
`coverage_mask` are host numpy, equal to the reference's bit for bit. The
copies and the coverage-class sums run on the params' device, with the
index maps and coverage classes cached there per (sizes, device); the
weights are the reference's numpy.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import staleness_weights, weighted_aggregate
from repro_torch.models.cnn import CNNConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


def _stage_widths(cfg: CNNConfig) -> List[tuple]:
    """[(c_in, c_out)] per conv stage."""
    widths, c_in = [], cfg.in_shape[2]
    for c in cfg.channels:
        widths.append((c_in, c))
        c_in = c
    return widths


def zeros_params(cfg: CNNConfig, device=None) -> Dict:
    """A zeroed parameter tree shaped like ``init_cnn(gen, cfg)``, on
    `device` (CUDA when None)."""
    device = resolve_device(device)
    h, w, c = cfg.flat_grid()

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {
        "conv": [z(3, 3, ci, co) for ci, co in _stage_widths(cfg)],
        "conv_b": [z(co) for _, co in _stage_widths(cfg)],
        "fc1": z(h * w * c, cfg.hidden),
        "fc1_b": z(cfg.hidden),
        "fc2": z(cfg.hidden, cfg.n_classes),
        "fc2_b": z(cfg.n_classes),
    }


@functools.lru_cache(maxsize=None)
def _shared_rows(src: CNNConfig, dst: CNNConfig):
    """fc1-row remap across the ragged flatten boundary.

    Returns (rows_src, rows_dst): aligned index vectors such that
    ``fc1_src[rows_src]`` and ``fc1_dst[rows_dst]`` enumerate the shared
    feature-grid sites ``(h, w, c)`` with ``h < min(H)``, ``w < min(W)``,
    ``c < min(C)`` in the same (h, w, c)-lexicographic order.
    """
    hs, ws, cs = src.flat_grid()
    hd, wd, cd = dst.flat_grid()
    h, w, c = np.meshgrid(np.arange(min(hs, hd)), np.arange(min(ws, wd)),
                          np.arange(min(cs, cd)), indexing="ij")
    return (((h * ws + w) * cs + c).ravel(), ((h * wd + w) * cd + c).ravel())


@functools.lru_cache(maxsize=None)
def _shared_rows_on(src: CNNConfig, dst: CNNConfig,
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
    """`_shared_rows` as int64 tensors on `device`."""
    return tuple(torch.from_numpy(r).to(device)
                 for r in _shared_rows(src, dst))


def _copy_shared(params, src: CNNConfig, dst: CNNConfig, base=None):
    """dst-shaped tree: the src/dst shared region copied out of `params`
    (src-shaped), everything else from `base` (zeros when None), on the
    params' device. src == dst with no base is an exact passthrough."""
    if src == dst and base is None:
        return params
    device = tree_leaves(params)[0].device
    if base is None:
        out = zeros_params(dst, device)
    else:
        out = tree_map(lambda x: x.clone(), base)
    sw, dw = _stage_widths(src), _stage_widths(dst)
    for j in range(min(len(src.channels), len(dst.channels))):
        ci = min(sw[j][0], dw[j][0])
        co = min(sw[j][1], dw[j][1])
        out["conv"][j][:, :, :ci, :co] = params["conv"][j][:, :, :ci, :co]
        out["conv_b"][j][:co] = params["conv_b"][j][:co]
    rows_s, rows_d = _shared_rows_on(src, dst, device)
    hid = min(src.hidden, dst.hidden)
    out["fc1"][rows_d, :hid] = params["fc1"][rows_s, :hid]
    out["fc1_b"][:hid] = params["fc1_b"][:hid]
    nc = min(src.n_classes, dst.n_classes)
    out["fc2"][:hid, :nc] = params["fc2"][:hid, :nc]
    out["fc2_b"][:nc] = params["fc2_b"][:nc]
    return out


def extract_submodel(params, src: CNNConfig, dst: CNNConfig, base=None):
    """Pull a dst-sized model out of a (typically larger) src-sized tree:
    shared-region entries come from `params`, the rest from `base`."""
    return _copy_shared(params, src, dst, base)


def embed_submodel(params, src: CNNConfig, dst: CNNConfig, base=None):
    """Plant a src-sized model into a (typically larger) dst-sized tree:
    the same partial map as `extract_submodel`, in the other direction —
    ``extract_submodel(embed_submodel(p, s, l), l, s) == p`` exactly
    whenever l fully covers s (e.g. small -> medium)."""
    return _copy_shared(params, src, dst, base)


@functools.lru_cache(maxsize=None)
def coverage_mask(target: CNNConfig, src: CNNConfig):
    """target-shaped boolean numpy tree: True where a src-sized model owns
    the entry under the nesting map. Derived by embedding an all-ones src
    tree (on the CPU), so it is exactly the region `_copy_shared` copies.
    Cached — treat the returned arrays as read-only."""
    ones = tree_map(torch.ones_like, zeros_params(src, "cpu"))
    return tree_map(lambda x: x.numpy() > 0, _copy_shared(ones, src, target))


@functools.lru_cache(maxsize=None)
def covers_all(target: CNNConfig, src: CNNConfig) -> bool:
    """True when a src-sized model contains every entry of a target-sized
    one (same-size always; small -> medium; not small -> large, whose extra
    pooling stage shrinks the shared flatten grid)."""
    return all(m.all() for m in tree_leaves(coverage_mask(target, src)))


@functools.lru_cache(maxsize=None)
def _coverage_classes(target: CNNConfig, present: Tuple[CNNConfig, ...],
                      device: torch.device):
    """Per leaf of a target-sized tree, [(covering, region)]: each coverage
    class present in the leaf, in ascending order of its code (a bit per
    entry of `present` whose region holds the entry, as the reference
    builds it), with the set of its covering indices into `present` and
    its boolean region on `device`. Entries nobody covers are left out."""
    masks = [tree_leaves(coverage_mask(target, t)) for t in present]
    out = []
    for li in range(len(masks[0])):
        code = np.zeros(masks[0][li].shape, np.int64)
        for k in range(len(present)):
            code |= np.int64(1 << k) * masks[k][li]
        out.append([(frozenset(k for k in range(len(present))
                               if (int(val) >> k) & 1),
                     torch.from_numpy(code == val).to(device))
                    for val in np.unique(code) if val != 0])
    return out


def nested_aggregate(global_by_size: Dict[str, object],
                     pool: Dict[str, CNNConfig],
                     client_params: List, client_sizes: List[str],
                     entropies: Sequence[float], accuracies: Sequence[float],
                     staleness: Optional[Sequence[int]] = None,
                     staleness_exponent: float = 0.5, mix: float = 1.0,
                     ) -> Dict[str, object]:
    """Cross-size coverage-weighted aggregation over a nested pool.

    For every size s and every entry e of its global model,

        theta_s[e] <- theta_s[e] + mix * (avg_e - theta_s[e])
        avg_e = sum_{i in C(e)} What_i * theta_i[e],   What_i = W_i / sum_{C(e)} W_j

    where C(e) is the set of clients whose model contains e under the
    nesting map and W are the Eq. 38 weights, staleness-discounted as in
    `staleness_weights`. Entries nobody covers keep their value. When every
    client covers all of s the formula collapses to `weighted_aggregate`
    (and is computed by it, keeping the single-size-pool case bit-identical
    to `group_aggregate`).
    """
    w_all = staleness_weights(entropies, accuracies, staleness,
                              staleness_exponent)
    present = sorted(set(client_sizes))
    out = dict(global_by_size)
    for s, cfg_s in pool.items():
        projs = [_copy_shared(p, pool[t], cfg_s)
                 for p, t in zip(client_params, client_sizes)]
        if all(covers_all(cfg_s, pool[t]) for t in present):
            out[s] = weighted_aggregate(global_by_size[s], projs, w_all,
                                        mix=mix)
            continue
        g_leaves = tree_leaves(global_by_size[s])
        classes = _coverage_classes(cfg_s, tuple(pool[t] for t in present),
                                    g_leaves[0].device)
        proj_leaves = [tree_leaves(p) for p in projs]
        new_leaves = []
        for li, g in enumerate(g_leaves):
            new = g.clone()
            for covering, region in classes[li]:
                sizes = {present[k] for k in covering}
                idx = [i for i, t in enumerate(client_sizes) if t in sizes]
                w = w_all[idx]
                w = (w / w.sum()).astype(np.float32)
                avg = proj_leaves[idx[0]][li] * float(w[0])
                for i, wi in zip(idx[1:], w[1:]):
                    avg = avg + proj_leaves[i][li] * float(wi)
                upd = (g + float(mix) * (avg - g)).to(g.dtype)
                new = torch.where(region, upd, new)
            new_leaves.append(new)
        out[s] = tree_unflatten(global_by_size[s], new_leaves)
    return out
