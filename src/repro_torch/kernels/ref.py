"""Plain PyTorch versions of the port's kernels: the path CPU tensors take,
and the oracle the CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

#: the mask value of `gqa_attention`'s scores (the reference's)
NEG_INF = -1e30


def kd_loss_ref(x_logits: torch.Tensor, y_logits: torch.Tensor,
                labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fused mutual-KD loss terms (paper Eqs. 33-34), per row.

    x_logits, y_logits: (N, V) float; labels: (N,) int.
    Returns per-row (N,) fp32: ce_x, ce_y, kl_xy (KL(X||Y)), kl_yx.
    """
    x, y = x_logits.float(), y_logits.float()
    lab = labels.long()[:, None]
    logp_x = torch.log_softmax(x, -1)
    logp_y = torch.log_softmax(y, -1)
    return {"ce_x": -logp_x.gather(-1, lab)[:, 0],
            "ce_y": -logp_y.gather(-1, lab)[:, 0],
            "kl_xy": (logp_x.exp() * (logp_x - logp_y)).sum(-1),
            "kl_yx": (logp_y.exp() * (logp_y - logp_x)).sum(-1)}


def kd_loss_fwd_ref(x_logits: torch.Tensor, y_logits: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel writes: terms (4, N) fp32 = (ce_x, ce_y,
    kl_xy, kl_yx) and the saved row statistics (4, N) fp32 = (lse_x, lse_y,
    e_x, e_y), where e_x = E_{p_x}[x - y] and e_y = E_{p_y}[y - x]."""
    x, y = x_logits.float(), y_logits.float()
    lab = labels.long()[:, None]
    lse_x = torch.logsumexp(x, -1)
    lse_y = torch.logsumexp(y, -1)
    p_x = torch.exp(x - lse_x[:, None])
    p_y = torch.exp(y - lse_y[:, None])
    e_x = (p_x * (x - y)).sum(-1)
    e_y = (p_y * (y - x)).sum(-1)
    terms = torch.stack([lse_x - x.gather(-1, lab)[:, 0],
                         lse_y - y.gather(-1, lab)[:, 0],
                         e_x - lse_x + lse_y,
                         e_y - lse_y + lse_x])
    return terms, torch.stack([lse_x, lse_y, e_x, e_y])


def kd_loss_bwd_ref(x_logits: torch.Tensor, y_logits: torch.Tensor,
                    labels: torch.Tensor, stats: torch.Tensor,
                    grads: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the backward kernel writes. grads (4, N) are the upstream
    per-row gradients of (ce_x, ce_y, kl_xy, kl_yx); stats as saved by the
    forward. kl_xy sends nothing to y and kl_yx nothing to x:

        dx = g_ce_x (p_x - onehot) + g_kl_xy p_x ((x - y) - e_x)
        dy = g_ce_y (p_y - onehot) + g_kl_yx p_y ((y - x) - e_y)

    dx, dy come back in the logits' dtype."""
    x, y = x_logits.float(), y_logits.float()
    lse_x, lse_y, e_x, e_y = (s[:, None] for s in stats)
    g_ce_x, g_ce_y, g_kl_xy, g_kl_yx = (g[:, None] for g in grads)
    onehot = torch.zeros_like(x).scatter_(1, labels.long()[:, None], 1.0)
    p_x = torch.exp(x - lse_x)
    p_y = torch.exp(y - lse_y)
    dx = g_ce_x * (p_x - onehot) + g_kl_xy * p_x * ((x - y) - e_x)
    dy = g_ce_y * (p_y - onehot) + g_kl_yx * p_y * ((y - x) - e_y)
    return dx.to(x_logits.dtype), dy.to(y_logits.dtype)


def kd_loss_grad_ref(x_logits: torch.Tensor, y_logits: torch.Tensor,
                     labels: torch.Tensor, lambdas: Sequence[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the one-launch kernel writes for the mutual-KD step, in closed
    form: logits (C, B, V) and labels (C, B), each client's loss
    L = l1 ce_x + l2 kl_xy + l3 ce_y + l4 kl_yx averaged over its batch,
    with the Eqs. 33-34 stop-gradients (kl_xy sends nothing to y, kl_yx
    nothing to x):

        dx = (l1/B) (p_x - onehot) + (l2/B) p_x ((x - y) - e_x)
        dy = (l3/B) (p_y - onehot) + (l4/B) p_y ((y - x) - e_y)

    in the logits' dtype, and means (6, C) fp32: each client's batch means
    of ce_x, ce_y, kl_xy, kl_yx and of the two argmax accuracies."""
    l1, l2, l3, l4 = (float(v) for v in lambdas)
    B = x_logits.shape[-2]
    x, y = x_logits.float(), y_logits.float()
    lab = labels.long()[..., None]
    lse_x = torch.logsumexp(x, -1, keepdim=True)
    lse_y = torch.logsumexp(y, -1, keepdim=True)
    p_x = torch.exp(x - lse_x)
    p_y = torch.exp(y - lse_y)
    diff = x - y
    e_x = (p_x * diff).sum(-1, keepdim=True)
    e_y = (p_y * -diff).sum(-1, keepdim=True)
    onehot = torch.zeros_like(x).scatter_(-1, lab, 1.0)
    dx = (l1 / B) * (p_x - onehot) + (l2 / B) * p_x * (diff - e_x)
    dy = (l3 / B) * (p_y - onehot) + (l4 / B) * p_y * (-diff - e_y)
    rows = torch.stack([
        (lse_x - x.gather(-1, lab))[..., 0],
        (lse_y - y.gather(-1, lab))[..., 0],
        (e_x - lse_x + lse_y)[..., 0],
        (e_y - lse_y + lse_x)[..., 0],
        (x_logits.argmax(-1) == labels).float(),
        (y_logits.argmax(-1) == labels).float()])
    return dx.to(x_logits.dtype), dy.to(y_logits.dtype), rows.mean(-1)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x (N, d), scale (d,) -> x * rsqrt(mean(x^2) + eps) * scale over each
    row, computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: (s, y) with s = x + delta in
    x's dtype and y = rmsnorm_ref(s, scale, eps)."""
    s = x + delta
    return s, rmsnorm_ref(s, scale, eps)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `rmsnorm_ref` in closed form: x, dy (N, d) and scale
    (d,) -> (dx (N, d) in x's dtype, dscale (d,) in scale's dtype). Per row,
    with r = rsqrt(mean(x^2) + eps), xhat = x r and w = scale, in fp32:

        dx = r (dy w - xhat mean(dy w xhat)),   dscale = sum_rows dy xhat
    """
    xf, w, g = x.float(), scale.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xhat = xf * r
    gw = g * w
    dx = r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), (g * xhat).sum(0).to(scale.dtype)


def add_rmsnorm_bwd_ref(s: torch.Tensor, scale: torch.Tensor,
                        g_s: Optional[torch.Tensor], g_y: torch.Tensor,
                        eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `add_rmsnorm_ref` from its saved sum s: the upstream
    gradients g_s of s (None when s went unused) and g_y of y -> (d_s,
    dscale). d_s = g_s + the norm's backward of g_y, summed in fp32 and
    rounded once to s's dtype; it is the gradient of both x and delta."""
    xf, w, g = s.float(), scale.float(), g_y.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xhat = xf * r
    gw = g * w
    dx = r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    if g_s is not None:
        dx = g_s.float() + dx
    return dx.to(s.dtype), (g * xhat).sum(0).to(scale.dtype)


def _flash_scores(q, k, causal, sliding_window, scale=None):
    """fp32 scores (B, H, S, S) with the masked pairs at -inf, and K
    repeated over each group's query heads; scaled by 1/sqrt(hd), or by
    `scale` where it is given."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    scores = q.float() @ kf.transpose(-1, -2)
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = j <= i
    if sliding_window:
        mask = mask & (j > i - sliding_window)
    return scores.masked_fill(~mask, float("-inf")), kf


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sliding_window: int = 0,
                        return_lse: bool = False, scale=None):
    """q (B, H, S, hd), k and v (B, KV, S, hd) with H % KV == 0 ->
    (B, H, S, hd) in q's dtype. Naive attention, materialised in fp32 with
    scale 1/sqrt(hd) (or `scale`, where given). Query head h reads KV head
    h // (H / KV), as ``models.attention.gqa_attention`` groups them. Key j
    is visible to query i when j <= i (causal) and j > i - sliding_window
    (when set).
    With return_lse, also each row's log-sum-exp of its scaled scores,
    (B, H, S) fp32, what the backward needs of the forward."""
    scores, _ = _flash_scores(q, k, causal, sliding_window, scale)
    G = q.shape[1] // k.shape[1]
    vf = v.float().repeat_interleave(G, dim=1)
    o = (torch.softmax(scores, -1) @ vf).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(scores, -1)
    return o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, sliding_window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward of `flash_attention_ref` in closed form, from the saved
    output o and row log-sum-exp lse: P = exp(S - lse), D = rowsum(dO o),

        dV = P^T dO,  dS = P (dO V^T - D),  dQ = dS K / sqrt(hd),
        dK = dS^T Q / sqrt(hd)

    in fp32, with dK and dV summed over the H / KV query heads of each KV
    head's group; returned in q's dtype and the shapes of q, k and v."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scores, kf = _flash_scores(q, k, causal, sliding_window)
    p = torch.exp(scores - lse[..., None].float())
    vf = v.float().repeat_interleave(G, dim=1)
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) / math.sqrt(hd)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ q.float()
    dk = dk.view(B, KV, G, S, hd).sum(2)
    dv = dv.view(B, KV, G, S, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------- #
# the model's plain attention (``repro.models.attention.gqa_attention``)
# ---------------------------------------------------------------------- #
def _gqa_scores_chunk(q, k, v, q_start, kv_len_valid, sliding_window, causal,
                      scale=None):
    """q: (B, KV, G, qc, hd); k, v: (B, KV, S, hd) -> (B, KV, G, qc, hd).
    Scores and probabilities are rounded to the inputs' dtype where the
    reference rounds them; scores scaled by 1/sqrt(hd), or `scale`."""
    S = k.shape[2]
    scores = torch.einsum("bkgqh,bkth->bkgqt", q, k).float()
    scores = (scores / math.sqrt(q.shape[-1]) if scale is None
              else scores * scale)
    q_idx = q_start + torch.arange(q.shape[3], device=q.device)
    k_idx = torch.arange(S, device=q.device)
    mask = torch.ones((q.shape[3], S), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_idx[None, :] <= q_idx[:, None]
    if sliding_window:
        mask = mask & (k_idx[None, :] > q_idx[:, None] - sliding_window)
    if kv_len_valid is not None:
        mask = mask & (k_idx[None, :] < kv_len_valid)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, -1).to(v.dtype)
    return torch.einsum("bkgqt,bkth->bkgqh", probs, v)


def gqa_attention(q, k, v, *, causal=True, sliding_window=0, q_start=0,
                  kv_len_valid=None, q_chunk=1024, scale=None):
    """q: (B, S_q, H, hd); k, v: (B, S_kv, KV, hd) -> (B, S_q, H, hd).
    Queries go in chunks of q_chunk rows, so the score matrix held at once
    is (B, KV, G, q_chunk, S_kv). Scores are scaled by 1/sqrt(hd), or by
    `scale` where given."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)  # (B, KV, G, Sq, hd)
    kh = k.permute(0, 2, 1, 3)                                # (B, KV, S, hd)
    vh = v.permute(0, 2, 1, 3)
    out = torch.cat([
        _gqa_scores_chunk(qh[:, :, :, i:i + q_chunk], kh, vh, q_start + i,
                          kv_len_valid, sliding_window, causal, scale)
        for i in range(0, Sq, q_chunk)], dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_index: torch.Tensor,
                         scale=None) -> torch.Tensor:
    """One-token decode attention: q (B, 1, H, hd) over the caches
    (B, L, KV, hd) at the 0-d int64 position cache_index, attending over
    the kv_valid = min(cache_index + 1, L) slots filled so far (the whole
    ring once it has wrapped) -> (B, 1, H, hd) in q's dtype. The
    reference's decode call: `gqa_attention` over all L slots with those
    past kv_valid masked, scores and probabilities rounded to the inputs'
    dtype between its two einsums."""
    kv_valid = torch.clamp(cache_index + 1, max=k_cache.shape[1])
    return gqa_attention(q, k_cache, v_cache, causal=False, sliding_window=0,
                         kv_len_valid=kv_valid, q_start=cache_index,
                         scale=scale)
