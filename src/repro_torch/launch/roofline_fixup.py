"""Analytic FLOPs of the inner scans: the cross-check of the dry run's
count for attention, SSD, mLSTM and sLSTM.

Counterpart of ``repro.launch.roofline_fixup``. XLA's cost analysis counts
a while-loop body once, so the reference adds the (trips - 1) / trips share
of three inner scans (the attention query-chunk scan, the SSD / mLSTM chunk
scans, the sLSTM time scan) by these formulas. The port's dry run
(`launch.dryrun`) runs eagerly on the meta device: its counter sees every
Python loop iteration (each SSD and mLSTM chunk, each sLSTM position), and
the flash kernel's work comes from its own formula (`kernels.cost`). There
is no undercount to repair, so `inner_scan_fixup` adds nothing: every
``*_fixed`` field equals its raw value. The four formulas stay, as the
cross-check the tests hold the dry run's per-mechanism count against.

What the formulas count against the port's count (forward, one pass):

* attention: 4 B H hd S kv_per_q a layer with kv_per_q = S / 2 causal (or
  the window); the flash kernel counts the visible pairs, S (S + 1) / 2,
  so the count is the formula's times (S + 1) / S.
* SSD: the four chunk products exactly.
* mLSTM: the formula has 3 Lc H Pk P state products a chunk; the chunk
  scan does 2 (q C and the k v^T update) and the normaliser's q n, so the
  count is the formula less 2 B Lc H Pk (P - 1) a chunk.
* sLSTM: the recurrent bmm exactly, 8 B d dh a position.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models import ssm

SSM_CHUNK = ssm.CHUNK


def _attention_scores_flops(cfg, B, S) -> float:
    """Total fwd FLOPs of the score/value products across all layers."""
    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    if cfg.sliding_window:
        kv_per_q = min(cfg.sliding_window, S)
    else:
        kv_per_q = S / 2  # causal mean
    per_layer = 2 * 2 * B * H * S * kv_per_q * hd
    n_attn = cfg.n_layers
    if cfg.shared_attn_every:  # zamba: one shared attn per segment
        n_attn = cfg.n_layers // cfg.shared_attn_every
    if cfg.block_kind == "xlstm":
        n_attn = 0
    return per_layer * n_attn


def _ssd_flops(cfg, B, S) -> float:
    if cfg.block_kind not in ("mamba2",) and cfg.family != "hybrid":
        return 0.0
    d, inner, H, P, n = ssm.mamba2_dims(cfg)
    Lc = min(SSM_CHUNK, S)
    nc = max(S // Lc, 1)
    per_chunk = 2 * B * (Lc * Lc * (n + H * P) + 2 * Lc * H * n * P)
    return per_chunk * nc * cfg.n_layers


def _mlstm_flops(cfg, B, S) -> float:
    if cfg.block_kind != "xlstm":
        return 0.0
    d, inner, H, P, Pk = ssm.mlstm_dims(cfg)
    Lc = min(SSM_CHUNK, S)
    nc = max(S // Lc, 1)
    g, m_per, tail = (cfg.n_layers // cfg.slstm_every,
                      cfg.slstm_every - 1,
                      cfg.n_layers % cfg.slstm_every)
    n_mlstm = g * m_per + tail
    per_chunk = 2 * B * (Lc * Lc * H * (Pk + P) + 3 * Lc * H * Pk * P)
    return per_chunk * nc * n_mlstm


def _slstm_flops(cfg, B, S) -> float:
    if cfg.block_kind != "xlstm":
        return 0.0
    d = cfg.d_model
    dh = d // cfg.n_heads
    n_slstm = cfg.n_layers // cfg.slstm_every
    return 4 * 2 * B * d * dh * S * n_slstm


def inner_scan_fixup(artifact: Dict) -> Dict:
    """The artifact with the *_fixed roofline fields added: each equal to
    its raw value, since the port's count already holds every iteration of
    the inner scans (see the module docstring)."""
    d = dict(artifact)
    for k in ("compute_s", "memory_s", "collective_s"):
        d[k + "_fixed"] = d[k]
    d["dominant_fixed"] = d["dominant"]
    d["inner_scan_extra_flops_per_chip"] = 0.0
    return d


def scan_flops(cfg, B: int, S: int) -> Dict[str, float]:
    """The four formulas for `cfg` at B x S positions, forward, all layers:
    {attention, ssd, mlstm, slstm}."""
    return {"attention": _attention_scores_flops(cfg, B, S),
            "ssd": _ssd_flops(cfg, B, S), "mlstm": _mlstm_flops(cfg, B, S),
            "slstm": _slstm_flops(cfg, B, S)}
