"""Communication-efficiency subsystem (DESIGN.md §13), on the port.

Quantized + sparsified update codecs with error feedback, turning the
simulator's wire-byte model from a constant (`params * 4`) into a lever:

  quantize  — per-tensor affine int8/int4 with counter-seeded stochastic
              rounding (pure in (seed, client, round) — the latency-jitter
              purity convention, so sync and event-driven runs agree)
  sparsify  — deterministic magnitude top-k selection / densification
  codec     — the `Codec` protocol (encode / decode / wire_bytes) and the
              identity, int8, int4, topk, topk+int8 instances; lossy
              codecs compress the delta from the dispatch-time global with
              per-client error-feedback residuals

The wire format is host numpy, the reference's byte for byte: a lossy
codec copies a tree of tensors to the host, encodes it there and decodes
back onto the reference tree's device. The identity codec never leaves
the device.

Wired into the stack: `CommModel(codec=...)` prices upload/download
events by codec wire bytes, and `HAPFLServer(codec=...)` round-trips every
client update through the codec before aggregation (EF state lives on
the server beside the PPO state).
"""
from repro_torch.comm.codec import (BYTES_F32, CODEC_NAMES, Codec,
                                    DensePayload, EncodedUpdate,
                                    IdentityCodec, QuantCodec, TopKCodec,
                                    TopKPayload, make_codec)
from repro_torch.comm.quantize import (QuantTensor, counter_uniform,
                                       dequantize, quantize)
from repro_torch.comm.sparsify import densify, topk_count, topk_select
