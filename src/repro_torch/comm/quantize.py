"""Per-tensor affine quantization with counter-seeded stochastic rounding.

The map is the standard asymmetric affine one: a float tensor x is sent as
integer levels q in [0, 2^bits - 1] with per-tensor (lo, scale),

    q = clip(floor((x - lo) / scale + u), 0, 2^bits - 1),   u ~ U[0, 1)
    dequant(q) = lo + q * scale,       scale = (max - min) / (2^bits - 1)

Stochastic rounding (the +u) makes dequantization *unbiased*,
E[dequant] = x, so quantization noise averages out across clients/rounds
instead of accumulating as bias.

The rounding draws follow the repo's latency-jitter purity convention
(core.latency): u is a pure function of the integer entropy tuple
(seed, client, round, tag, leaf), never a shared generator, so the
event-driven and synchronous simulators produce byte-identical encodings
no matter when or in what order waves are encoded.

Levels are stored one-per-uint8 even for int4 (simulation convenience);
wire accounting (repro_torch.comm.codec) charges bits/8 bytes per element, as a
real packer would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

_M32 = 0xFFFFFFFF

#: per-tensor affine map (lo, scale) as 2xf32 — the one overhead constant
#: shared by the exact (QuantTensor.wire_bytes) and analytic
#: (codec.QuantCodec.wire_bytes) sides of the accounting
BYTES_AFFINE_MAP = 8.0


def counter_uniform(n: int, *entropy: int) -> np.ndarray:
    """n uniform [0,1) draws keyed purely by the given integers — the same
    stream no matter when or in what order it is requested."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(e) & _M32 for e in entropy]))
    return rng.random(n)


@dataclass
class QuantTensor:
    """One quantized tensor: integer levels + the per-tensor affine map."""
    q: np.ndarray              # uint8 levels, flat
    lo: float
    scale: float
    shape: Tuple[int, ...]
    bits: int

    @property
    def wire_bytes(self) -> float:
        # levels at bits/8 bytes each + the per-tensor affine map
        return self.q.size * self.bits / 8.0 + BYTES_AFFINE_MAP


def quantize(x: np.ndarray, bits: int, *entropy: int) -> QuantTensor:
    """Stochastic-rounding affine quantization of `x` to `bits` bits.

    A constant tensor (max == min) quantizes exactly: scale falls back to
    1.0, every level is 0 and dequantize returns `lo` everywhere.
    """
    if bits < 1 or bits > 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    flat = np.asarray(x, np.float32).ravel()
    lo = float(flat.min()) if flat.size else 0.0
    hi = float(flat.max()) if flat.size else 0.0
    levels = (1 << bits) - 1
    scale = (hi - lo) / levels if hi > lo else 1.0
    u = counter_uniform(flat.size, *entropy)
    q = np.floor((flat.astype(np.float64) - lo) / scale + u)
    q = np.clip(q, 0, levels).astype(np.uint8)
    return QuantTensor(q=q, lo=lo, scale=scale,
                       shape=tuple(np.shape(x)), bits=bits)


def dequantize(qt: QuantTensor) -> np.ndarray:
    return (qt.lo + qt.q.astype(np.float32) * np.float32(qt.scale)
            ).astype(np.float32).reshape(qt.shape)
