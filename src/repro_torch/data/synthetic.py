"""Deterministic synthetic datasets (offline stand-ins for MNIST/CIFAR/ImageNet-10).

Images are class-conditional: every class owns a fixed random 2-D frequency
signature; samples are that signature at a random phase + Gaussian noise,
so CNNs can genuinely learn the task (accuracy curves behave like the real
thing structurally, as noted in DESIGN.md §5). Token datasets are Zipf-ish
streams for the transformer substrate.
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np


def make_image_dataset(name: str, n_train: int = 6000, n_test: int = 1000,
                       n_classes: int = 10, seed: int = 1234,
                       ) -> Dict[str, np.ndarray]:
    shapes = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3),
              "imagenet10": (64, 64, 3)}
    noise = {"mnist": 0.25, "cifar10": 0.55, "imagenet10": 0.75}[name]
    H, W, C = shapes[name]
    # crc32, not hash(): str hashes are salted per process, which silently
    # made "deterministic" datasets differ between runs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 10000)
    # per-class frequency signatures
    fy = rng.uniform(0.5, 4.0, size=(n_classes, C, 3))
    fx = rng.uniform(0.5, 4.0, size=(n_classes, C, 3))
    amp = rng.uniform(0.5, 1.0, size=(n_classes, C, 3))

    def gen(n, rng):
        labels = rng.integers(0, n_classes, size=n)
        phase = rng.uniform(0, 2 * np.pi, size=(n, C, 3))
        yy = np.linspace(0, 2 * np.pi, H)[None, :, None, None, None]
        xx = np.linspace(0, 2 * np.pi, W)[None, None, :, None, None]
        f_y = fy[labels][:, None, None]   # (n,1,1,C,3)
        f_x = fx[labels][:, None, None]
        a = amp[labels][:, None, None]
        ph = phase[:, None, None]
        img = np.sum(a * np.sin(f_y * yy + f_x * xx + ph), axis=-1)  # (n,H,W,C)
        img = img / 3.0 + noise * rng.standard_normal((n, H, W, C))
        return img.astype(np.float32), labels.astype(np.int32)

    xtr, ytr = gen(n_train, rng)
    xte, yte = gen(n_test, rng)
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte,
            "n_classes": n_classes}


def make_token_dataset(vocab_size: int, n_tokens: int = 1 << 16,
                       seed: int = 0) -> np.ndarray:
    """Zipf-distributed token stream with local bigram structure."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab_size, size=n_tokens, p=p)
    # inject determinism: every 3rd token repeats (learnable structure)
    toks[2::3] = toks[1::3][: len(toks[2::3])]
    return toks.astype(np.int32)
