"""Update codecs: what actually goes over the simulated wire.

A `Codec` turns a client's trained parameter pytree into an
`EncodedUpdate` (what the client uploads) and back. Lossy codecs operate
on the *delta* from the reference global the client trained from, with
per-client error-feedback (EF) residuals:

    e_t      = (theta_client - theta_ref) + r_{t-1}     # EF-corrected delta
    msg_t    = compress(e_t)
    r_t      = e_t - decompress(msg_t)                  # carried to next round
    decode   = theta_ref + decompress(msg_t)

The residual state `r` is owned by the caller (HAPFLServer keeps it per
(client, kind, size) beside the PPO state) and threaded through
`encode(..., state=...) -> (encoded, new_state)`; codecs themselves are
stateless, so one instance can serve every client.

The identity codec short-circuits the delta form entirely — encode/decode
pass the original leaf tensors through untouched, on their device, so
`HAPFLServer(codec="identity")` is *bit*-identical to the legacy server
(`theta_ref + (theta - theta_ref)` would already drift a ulp).

Leaves are tensors on any device. A lossy codec copies them to the host
as float32, encodes there exactly as the reference does
(the rounding draws are a `SeedSequence` stream), and decodes onto the
reference tree's device and dtype.

Wire-byte accounting exists in two forms that share one formula set:
`EncodedUpdate.wire_bytes` (exact, summed over the encoded leaves) and
`Codec.wire_bytes(n_params, n_tensors)` (analytic, from counts only) —
the latter is what `CommModel` uses to price upload/download events at
dispatch time, before any training has produced an actual message.
Dense floats are charged 4 bytes/param; quantized levels bits/8; top-k
indices 4 bytes; per-tensor overheads (affine map 2xf32, k count 1xi32)
are charged per leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.comm.quantize import (BYTES_AFFINE_MAP, QuantTensor,
                                       dequantize, quantize)
from repro_torch.comm.sparsify import densify, topk_count, topk_select
from repro_torch.obs.trace import current as _tracer

# stable integer tags mixed into the stochastic-rounding entropy so the
# "local" and "lite" halves of one client's update draw distinct streams
TAGS = {"local": 0, "lite": 1}

BYTES_F32 = 4.0              # dense float32 parameter
BYTES_IDX = 4.0              # top-k index (int32)
BYTES_MAP = BYTES_AFFINE_MAP  # per-tensor affine map (lo, scale) as 2xf32
BYTES_CNT = 4.0              # per-tensor top-k count (int32)


def _check_bits(bits: int) -> int:
    """quantize() supports 1..8-bit levels; reject anything else at codec
    construction instead of deep inside the first training round."""
    bits = int(bits)
    if not 1 <= bits <= 8:
        raise ValueError(f"quantization bits must be in [1, 8], got {bits}")
    return bits


def _flatten(tree):
    """(leaves, treedef) in jax.tree_util's order: a dict's children by
    sorted key, lists and tuples in order, None an empty node. The leaf
    index is part of each leaf's rounding entropy, so the encodings equal
    the reference's only in this order (`utils.pytree` keeps insertion
    order)."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                (dict, keys, tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree), len(tree), tuple(d for _, d in parts)))
    if tree is None:
        return [], None
    return [tree], "*"


def _unflatten(treedef, leaves):
    """Inverse of `_flatten` (dicts come back with sorted keys, as
    jax.tree_util's do)."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, keys, kids = d
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, kids)}
        return kind(build(c) for c in kids)
    return build(treedef)


def _host(leaves: List[torch.Tensor]) -> List[np.ndarray]:
    """float32 host copies of a tree's tensors (the reference's
    np.asarray), in one device-to-host copy."""
    flat = torch.cat([x.detach().float().reshape(-1) for x in leaves])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].reshape(tuple(x.shape)))
        at += x.numel()
    return out


def _to_like(arrays: List[np.ndarray],
             like: List[torch.Tensor]) -> List[torch.Tensor]:
    """float32 host arrays back onto the device and dtype of the matching
    tensors of `like`, in one host-to-device copy."""
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    flat = flat.to(like[0].device)
    return [piece.view(tuple(r.shape)).to(r.dtype) for piece, r in
            zip(flat.split([a.size for a in arrays]), like)]


@dataclass
class DensePayload:
    """A leaf shipped as raw float32 (TopKCodec's `dense_min` floor)."""
    arr: np.ndarray

    @property
    def wire_bytes(self) -> float:
        return self.arr.size * BYTES_F32


@dataclass
class TopKPayload:
    """One sparsified tensor: support indices + (possibly quantized) values."""
    idx: np.ndarray                    # int32, ascending
    vals: Any                          # float32 ndarray | QuantTensor
    shape: Tuple[int, ...]

    @property
    def wire_bytes(self) -> float:
        v = (self.vals.wire_bytes if isinstance(self.vals, QuantTensor)
             else self.vals.size * BYTES_F32)
        return self.idx.size * BYTES_IDX + v + BYTES_CNT


@dataclass
class EncodedUpdate:
    """One encoded client update (one model's pytree)."""
    codec: str
    treedef: Any
    payloads: List[Any]
    wire_bytes: float


class Codec:
    """encode/decode/wire_bytes protocol; see module docstring."""

    name = "codec"
    is_identity = False

    def encode(self, params, reference, state=None, *, seed: int = 0,
               client: int = 0, round_idx: int = 0, tag: str = "local",
               ):  # -> (EncodedUpdate, new_state)
        raise NotImplementedError

    def decode(self, encoded: EncodedUpdate, reference):
        raise NotImplementedError

    def wire_bytes(self, n_params: float, n_tensors: int = 0) -> float:
        """Analytic uplink bytes for a model of `n_params` parameters in
        `n_tensors` tensors (float32 dense baseline = 4 * n_params)."""
        raise NotImplementedError


class IdentityCodec(Codec):
    """Dense float32 passthrough — the legacy wire format, bit for bit."""

    name = "identity"
    is_identity = True

    def encode(self, params, reference, state=None, **_):
        with _tracer().span("codec.encode", codec=self.name):
            leaves, treedef = _flatten(params)
            n = sum(x.numel() for x in leaves)
            return EncodedUpdate("identity", treedef, leaves,
                                 n * BYTES_F32), None

    def decode(self, encoded, reference):
        with _tracer().span("codec.decode", codec=self.name):
            return _unflatten(encoded.treedef, encoded.payloads)

    def wire_bytes(self, n_params, n_tensors=0):
        return float(n_params) * BYTES_F32


class _DeltaCodec(Codec):
    """Shared delta + error-feedback machinery for the lossy codecs."""

    def _encode_leaf(self, delta: np.ndarray, entropy: Tuple[int, ...]):
        raise NotImplementedError

    def _decode_leaf(self, payload) -> np.ndarray:
        raise NotImplementedError

    def encode(self, params, reference, state=None, *, seed=0, client=0,
               round_idx=0, tag="local"):
        with _tracer().span("codec.encode", codec=self.name,
                            client=int(client), tag=tag):
            return self._encode(params, reference, state, seed, client,
                                round_idx, tag)

    def _encode(self, params, reference, state, seed, client, round_idx,
                tag):
        p_leaves, treedef = _flatten(params)
        r_leaves, r_def = _flatten(reference)
        if treedef != r_def:
            raise ValueError(f"params/reference structure mismatch: "
                             f"{treedef} vs {r_def}")
        if state is not None and len(state) != len(p_leaves):
            raise ValueError("EF state does not match the parameter tree "
                             "(model size changed? key EF per size)")
        payloads, new_state, total = [], [], 0.0
        for li, (p, r) in enumerate(zip(_host(p_leaves), _host(r_leaves))):
            delta = p - r
            if state is not None:
                delta = delta + state[li]
            pay = self._encode_leaf(
                delta, (seed, client, round_idx, TAGS.get(tag, 7), li))
            payloads.append(pay)
            new_state.append(delta - self._decode_leaf(pay))
            total += pay.wire_bytes
        return EncodedUpdate(self.name, treedef, payloads, total), new_state

    def decode(self, encoded, reference):
        with _tracer().span("codec.decode", codec=self.name):
            r_leaves, r_def = _flatten(reference)
            if encoded.treedef != r_def:
                raise ValueError("encoded/reference structure mismatch")
            leaves = [(r + self._decode_leaf(p)).astype(np.float32)
                      for r, p in zip(_host(r_leaves), encoded.payloads)]
            return _unflatten(encoded.treedef, _to_like(leaves, r_leaves))


class QuantCodec(_DeltaCodec):
    """Dense per-tensor affine quantization of the EF-corrected delta."""

    def __init__(self, bits: int):
        self.bits = _check_bits(bits)
        self.name = f"int{self.bits}"

    def _encode_leaf(self, delta, entropy):
        return quantize(delta, self.bits, *entropy)

    def _decode_leaf(self, payload):
        return dequantize(payload)

    def wire_bytes(self, n_params, n_tensors=0):
        return float(n_params) * self.bits / 8.0 + n_tensors * BYTES_MAP


class TopKCodec(_DeltaCodec):
    """Magnitude top-k of the EF-corrected delta; `bits` additionally
    quantizes the surviving values (the ``topk+int8`` composition).

    Leaves of `dense_min` entries or fewer ship as raw float32 instead
    (the DGC convention of not sparsifying biases/small layers: they are
    a rounding error of the payload but carry outsized signal). The
    analytic `wire_bytes` ignores the floor — by construction those
    leaves are too small to move the total."""

    def __init__(self, ratio: float = 0.05, bits: Optional[int] = None,
                 dense_min: int = 0):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        self.ratio = float(ratio)
        self.bits = None if bits is None else _check_bits(bits)
        self.dense_min = int(dense_min)
        self.name = "topk" if bits is None else f"topk+int{self.bits}"

    def _encode_leaf(self, delta, entropy):
        if delta.size <= self.dense_min:
            return DensePayload(np.asarray(delta, np.float32))
        idx, vals = topk_select(delta, self.ratio)
        if self.bits is not None:
            vals = quantize(vals, self.bits, *entropy)
        return TopKPayload(idx=idx, vals=vals, shape=tuple(delta.shape))

    def _decode_leaf(self, payload):
        if isinstance(payload, DensePayload):
            return payload.arr
        vals = (dequantize(payload.vals).ravel()
                if isinstance(payload.vals, QuantTensor) else payload.vals)
        return densify(payload.idx, vals, payload.shape)

    def wire_bytes(self, n_params, n_tensors=0):
        k = topk_count(int(round(n_params)), self.ratio)
        per_val = BYTES_F32 if self.bits is None else self.bits / 8.0
        over = BYTES_CNT + (0.0 if self.bits is None else BYTES_MAP)
        return k * (BYTES_IDX + per_val) + n_tensors * over


#: codec names in the order benchmarks sweep them (dense first)
CODEC_NAMES = ("identity", "int8", "int4", "topk", "topk+int8")


def make_codec(spec, **kw) -> Codec:
    """Resolve a codec spec: a Codec instance passes through; a name from
    `CODEC_NAMES` (aliases: ``topk_int8``, ``topk+int4``...) constructs one.
    Keyword args (e.g. ``ratio=``) go to the constructor."""
    if isinstance(spec, Codec):
        if kw:
            raise ValueError("kwargs only apply when constructing by name")
        return spec
    name = str(spec).replace("_", "+").lower()
    if name == "identity":
        return IdentityCodec()
    if name.startswith("int"):
        return QuantCodec(bits=int(name[3:]))
    if name == "topk":
        return TopKCodec(**kw)
    if name.startswith("topk+int"):
        return TopKCodec(bits=int(name[len("topk+int"):]), **kw)
    raise ValueError(f"unknown codec {spec!r} (known: {CODEC_NAMES})")
