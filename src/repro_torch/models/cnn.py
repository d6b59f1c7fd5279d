"""CNN model pool for the HAPFL experiments (paper §V), on PyTorch.

The paper uses CNNs "tailored to different datasets" in three sizes:
LiteModel, small, large. The layouts are the reference's: NHWC images, HWIO
conv kernels, (flat, hidden) and (hidden, classes) fc weights, and fc1's
rows in NHWC flatten order (``CNNConfig.flat_grid``), so params carry across
to and from ``repro.models.cnn`` unchanged.

`apply_cnn` is the evaluation path (cuDNN convolutions). `apply_cnn_fast`
is the training path of the cohort engine: im2col GEMMs and slice max-pool
over a leading client axis, params stacked (C, ...).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class CNNConfig:
    name: str
    in_shape: Tuple[int, int, int]          # (H, W, C)
    channels: Tuple[int, ...]               # conv channels per stage (stride-2 pool each)
    hidden: int
    n_classes: int = 10

    def flat_grid(self) -> Tuple[int, int, int]:
        """(H, W, C) of the feature map entering fc1: the row layout of the
        flatten boundary (row index = (h*W + w)*C + c, NHWC row-major)."""
        h = self.in_shape[0] // (2 ** len(self.channels))
        w = self.in_shape[1] // (2 ** len(self.channels))
        return max(h, 1), max(w, 1), self.channels[-1]

    def num_tensors(self) -> int:
        """Leaf-tensor count of an init_cnn pytree: (kernel, bias) per conv
        stage + fc1/fc1_b/fc2/fc2_b. Feeds the update codecs' per-tensor
        wire-byte overheads (repro.comm, CommModel.model_tensors)."""
        return 2 * len(self.channels) + 4

    def num_params(self) -> int:
        c_in = self.in_shape[2]
        total = 0
        for c in self.channels:
            total += 3 * 3 * c_in * c + c
            c_in = c
        h, w, _ = self.flat_grid()
        flat = h * w * c_in
        total += flat * self.hidden + self.hidden
        total += self.hidden * self.n_classes + self.n_classes
        return total


def config_nests_in(inner: CNNConfig, outer: CNNConfig) -> bool:
    """True when `inner`'s widths are leading slices of `outer`'s: same input
    and classes, no more conv stages, and elementwise-smaller channel/hidden
    widths on the shared stages. This is what makes cross-size aggregation
    (core.nested, DESIGN.md §12) well defined on the pool."""
    return (inner.in_shape == outer.in_shape
            and inner.n_classes == outer.n_classes
            and len(inner.channels) <= len(outer.channels)
            and all(ci <= co for ci, co in zip(inner.channels, outer.channels))
            and inner.hidden <= outer.hidden)


def nested_order(pool: Dict[str, CNNConfig]) -> List[str]:
    """Pool size names ordered smallest-to-largest by width (depth, then
    channels, then hidden). Not parameter count: an extra pooling stage
    shrinks the flatten layer, so a deeper model can have *fewer* params
    than a shallower one (imagenet10 medium vs large) while still being
    the wider architecture."""
    return sorted(pool, key=lambda s: (len(pool[s].channels),
                                       pool[s].channels, pool[s].hidden))


def assert_nested_pool(pool: Dict[str, CNNConfig]) -> None:
    """Every pair of pool configs, ordered by size, must nest."""
    order = nested_order(pool)
    for a, b in zip(order, order[1:]):
        if not config_nests_in(pool[a], pool[b]):
            raise AssertionError(
                f"model pool is not width-nested: {pool[a]} !< {pool[b]}")


def cnn_pool(dataset: str) -> Dict[str, CNNConfig]:
    """The paper's {LiteModel, small, large} pool per dataset. The pool is
    width-nested by construction (8 <= 16,32 <= 24,48 <= 32,64,128) and
    `assert_nested_pool` pins that invariant — cross-size aggregation
    depends on it."""
    shapes = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3), "imagenet10": (64, 64, 3)}
    s = shapes[dataset]
    pool = {
        "lite": CNNConfig(f"{dataset}-lite", s, (8,), 32),
        "small": CNNConfig(f"{dataset}-small", s, (16, 32), 64),
        "medium": CNNConfig(f"{dataset}-medium", s, (24, 48), 96),
        "large": CNNConfig(f"{dataset}-large", s, (32, 64, 128), 128),
    }
    assert_nested_pool(pool)
    return pool


def init_cnn(gen: torch.Generator, cfg: CNNConfig, device=None):
    """He-normal convs and fc1, fan-in-normal fc2, zero biases (the
    reference's distributions), drawn from `gen` on its own device and
    placed on `device` (CUDA when None)."""
    device = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=gen.device) * std
        return w.to(device)

    params = {"conv": [], "conv_b": []}
    c_in = cfg.in_shape[2]
    for c in cfg.channels:
        params["conv"].append(normal((3, 3, c_in, c),
                                     math.sqrt(2.0 / (9 * c_in))))
        params["conv_b"].append(torch.zeros(c, device=device))
        c_in = c
    h, w_, _ = cfg.flat_grid()
    flat = h * w_ * c_in
    params["fc1"] = normal((flat, cfg.hidden), math.sqrt(2.0 / flat))
    params["fc1_b"] = torch.zeros(cfg.hidden, device=device)
    params["fc2"] = normal((cfg.hidden, cfg.n_classes),
                           math.sqrt(1.0 / cfg.hidden))
    params["fc2_b"] = torch.zeros(cfg.n_classes, device=device)
    return params


def apply_cnn(params, cfg: CNNConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes). Convolutions run in
    NCHW; the feature map goes back to NHWC before the flatten."""
    x = images.float().permute(0, 3, 1, 2)
    for w, b in zip(params["conv"], params["conv_b"]):
        x = F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1)
        x = F.max_pool2d(F.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"] + params["fc1_b"])
    return x @ params["fc2"] + params["fc2_b"]


def _maxpool2x2_slice(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of (..., H, W, C) as strided slices + maximum; odd
    trailing rows/cols are dropped (VALID)."""
    H, W = x.shape[-3] // 2 * 2, x.shape[-2] // 2 * 2
    x = x[..., :H, :W, :]
    return torch.maximum(
        torch.maximum(x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :]),
        torch.maximum(x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]))


def _conv3x3_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of x (C, B, H, W, Ci) with w (C, 3, 3, Ci, Co) as
    im2col + one batched GEMM per client: (C, B*H*W, 9*Ci) @ (C, 9*Ci, Co).
    Patch columns are ordered (i, j, ci), matching w's HWIO flatten."""
    C, B, H, W, Ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    pat = torch.cat([xp[:, :, i:i + H, j:j + W, :]
                     for i in range(3) for j in range(3)], -1)
    out = torch.bmm(pat.reshape(C, B * H * W, 9 * Ci),
                    w.reshape(C, 9 * Ci, -1))
    return out.reshape(C, B, H, W, -1)


def apply_cnn_fast(params, cfg: CNNConfig, images: torch.Tensor
                   ) -> torch.Tensor:
    """apply_cnn over a leading client axis, by im2col GEMMs and slice
    max-pool. params leaves are stacked (C, ...); images (C, B, H, W, Cin)
    -> logits (C, B, n_classes)."""
    x = images.float()
    for w, b in zip(params["conv"], params["conv_b"]):
        y = _conv3x3_im2col(x, w) + b[:, None, None, None, :]
        x = _maxpool2x2_slice(F.relu(y))
    x = x.reshape(x.shape[0], x.shape[1], -1)
    x = F.relu(torch.bmm(x, params["fc1"]) + params["fc1_b"][:, None])
    return torch.bmm(x, params["fc2"]) + params["fc2_b"][:, None]
