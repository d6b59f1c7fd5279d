"""The port's kernels: the entry points the model and the HAPFL step call.

Counterpart of ``repro.kernels.ops``. Where the reference runs its Pallas
kernels in interpret mode off the TPU, here each wrapper dispatches on its
tensors' device: the CUDA kernel for CUDA tensors, the plain version
(`repro_torch.kernels.ref`) for CPU tensors. A device profile names and
times each launch; the phase spans (`repro_torch.obs.trace.phase`) time the
layers around them.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_attn)
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.kd_loss import kd_loss as _kd
from repro_torch.kernels.kd_loss import kd_loss_grad as _kd_grad
from repro_torch.kernels.rmsnorm import add_rmsnorm as _add_rms
from repro_torch.kernels.rmsnorm import rmsnorm as _rms


def flash_attention_op(q, k, v, *, causal=True, sliding_window=0,
                       scale=None):
    """q (B, H, S, hd); k, v (B, KV, S, hd) with H % KV == 0; scores scaled
    by `scale` (1/sqrt(hd) when None)."""
    return _flash(q, k, v, causal=causal, sliding_window=sliding_window,
                  scale=scale)


def decode_attention_op(q, k_cache, v_cache, cache_index, *, scale=None):
    """q (B, 1, H, hd) over the KV caches (B, L, KV, hd) at the 0-d int64
    position cache_index, over the min(cache_index + 1, L) slots filled;
    scores scaled by `scale` (1/sqrt(hd) when None)."""
    return _decode_attn(q, k_cache, v_cache, cache_index, scale=scale)


def kd_loss_op(x_logits, y_logits, labels):
    """(N, V) x 2 + (N,) labels -> per-row {ce_x, ce_y, kl_xy, kl_yx},
    differentiable through the backward kernel."""
    return _kd(x_logits, y_logits, labels)


def kd_loss_grad_op(x_logits, y_logits, labels, lambdas):
    """(C, B, V) x 2 + (C, B) labels -> (dx, dy, means (6, C)): the
    mutual-KD step's logit gradients and batch means in one launch."""
    return _kd_grad(x_logits, y_logits, labels, lambdas)


def rmsnorm_op(x, scale, *, eps=1e-5):
    return _rms(x, scale, eps)


def add_rmsnorm_op(x, delta, scale, *, eps=1e-5):
    """(N, d) rows x, delta -> (x + delta, rmsnorm(x + delta))."""
    return _add_rms(x, delta, scale, eps)
