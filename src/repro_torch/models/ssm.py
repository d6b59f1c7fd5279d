"""SSM / recurrent blocks: Mamba2 (SSD), mLSTM and sLSTM (xLSTM).

Counterpart of ``repro.models.ssm``, function for function. The sequence
is processed in the reference's chunkwise-parallel form: attention-like
products inside a chunk of ``CHUNK`` positions, and the recurrent state
carried from chunk to chunk by a Python loop where the reference runs a
``lax.scan``. The sLSTM has recurrent weights, so it stays a loop over
time steps; its four recurrent products run as one batched matmul against
``r`` laid out (H, dh, 4 dh), and its state is kept head-major (H, B, dh)
through the loop. The reference's ``shard(...)`` annotations are dropped,
as in `models/layers.py`.

Dtypes are the reference's: the projections run in the model dtype, the
gates, ``r`` and every recurrent state in fp32. The log-space stabilisers
are kept (-1e30 for an empty max, -inf for masked log-weights). Masked
entries are filled before their ``exp`` (``masked_fill``), so they give 0
and pass a zero gradient, where ``where`` after the ``exp`` would pass
0 * inf.

Loops take their per-step inputs from one ``unbind`` or ``split`` of the
whole sequence, made before the loop: under autograd its backward stacks
the steps' gradients once, where indexing inside the loop would write a
zero tensor of the whole sequence for every step (quadratic in L).

Products of three operands are written as two steps, the elementwise
scale first, so that no (B, L, H, P, n)-sized outer product is ever made
whatever path ``torch.einsum`` would pick; the sums are the reference's,
rounded in another order.

Decode (a dict cache and one new position) writes every recurrent state
back into its cache tensor in place: Mamba2's ``conv`` and ``ssm``, the
mLSTM's ``C``, ``n`` and ``m``, the sLSTM's ``h``, ``c``, ``n`` and
``m``. The serve engine's CUDA graph replays the step on static buffers
and keeps none of the step's outputs but its logits, so a state returned
without being written back would be lost at every step. Each apply
function returns that same cache dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.obs.trace import phase

MAMBA_HEAD_DIM = 64
CHUNK = 128
NEG_BIG = -1e30


def _causal_mask(Lc: int, device) -> torch.Tensor:
    """(Lc, Lc) bool, True where the source s is at or before the target t
    (row t, column s)."""
    return torch.ones((Lc, Lc), dtype=torch.bool, device=device).tril()


def _chunk_len(L: int) -> int:
    """The chunk length of a sequence of L positions: CHUNK, or L where it
    is shorter. A length it does not divide ends in a shorter chunk, whose
    causal mask is the top-left corner of the whole chunk's."""
    return min(CHUNK, L)


# ===================================================================== #
# Mamba2 (SSD)
# ===================================================================== #
def mamba2_dims(cfg: ModelConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    inner = 2 * d
    P = min(MAMBA_HEAD_DIM, inner)
    H = inner // P
    n = cfg.ssm_state or 64
    return d, inner, H, P, n


def mamba2_conv_dim(cfg: ModelConfig, d_model: Optional[int] = None) -> int:
    """The conv's channels: x, then B and C of each of cfg.mamba_groups."""
    d, inner, H, P, n = mamba2_dims(cfg, d_model)
    return inner + 2 * cfg.mamba_groups * n


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device,
                d_model: Optional[int] = None):
    """The reference's leaves; family "zamba2" adds "gnorm", the gated
    RMSNorm's scale (ones)."""
    d, inner, H, P, n = mamba2_dims(cfg, d_model)
    conv_dim = mamba2_conv_dim(cfg, d_model)
    in_proj = dense_init(gen, d, inner + conv_dim + H, cfg.dtype, device)
    conv_w = (torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                          device=device) * 0.1).to(cfg.dtype)
    u = torch.rand((H,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    out = {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=device),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),       # inv softplus
        "d_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, inner, d, cfg.dtype, device),
    }
    if cfg.family == "zamba2":
        out["gnorm"] = torch.ones((inner,), dtype=cfg.dtype, device=device)
    return out


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, L, C), w: (w, C), state: (B, w-1, C).
    Returns (silu(conv), the last w-1 inputs, the state included)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    L = x.shape[1]
    out = xp[:, 0:L] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + L] * w[i]
    out = out + b
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return F.silu(out), new_state


def _ssd_chunk_scan(xh, Bm, Cm, dt, A):
    """Chunkwise SSD. xh: (B, L, H, P); Bm, Cm: (B, L, n); dt: (B, L, H)
    fp32; A: (H,) (< 0). Returns y: (B, L, H, P) and the final state
    (B, H, n, P), both fp32."""
    Bsz, L, H, P = xh.shape
    n = Bm.shape[-1]
    Lc = _chunk_len(L)
    masked = ~_causal_mask(Lc, xh.device)[None, :, :, None]
    h = xh.new_zeros((Bsz, H, n, P), dtype=torch.float32)
    ys = []
    for xk, Bk, Ck, dtk in zip(*(t.float().split(Lc, 1)
                                 for t in (xh, Bm, Cm, dt))):
        r = xk.shape[1]                                    # Lc, or the tail
        a = dtk * A                                        # (B, Lc, H) < 0
        cum = torch.cumsum(a, 1)
        cum_end = cum[:, -1]                               # (B, H)
        # inter-chunk: y_t += exp(cum_t) * C_t . h_prev
        y_inter = (torch.einsum("bln,bhnp->blhp", Ck, h)
                   * torch.exp(cum)[..., None])
        # intra-chunk: seg[t, s] = cum_t - cum_s, masked above the diagonal
        seg = cum[:, :, None, :] - cum[:, None, :, :]      # (B, Lc, Lc, H)
        decay = torch.exp(seg.masked_fill(masked[:, :r, :r], -math.inf))
        cb = torch.einsum("bln,bsn->bls", Ck, Bk)          # (B, Lc, Lc)
        xdt = xk * dtk[..., None]                          # (B, Lc, H, P)
        y_intra = torch.einsum("blsh,bshp->blhp", cb[..., None] * decay, xdt)
        # state update
        w_state = torch.exp(cum_end[:, None, :] - cum)     # (B, Lc, H)
        s_chunk = torch.einsum("bsn,bshp->bhnp", Bk,
                               xdt * w_state[..., None])
        h = torch.exp(cum_end)[:, :, None, None] * h + s_chunk
        ys.append(y_inter + y_intra)
    return torch.cat(ys, 1), h


def apply_mamba2(params, cfg: ModelConfig, x, cache=None,
                 d_model: Optional[int] = None):
    """x: (B, L, d). cache: None (train), "init" (prefill: the final state
    comes back as the cache) or {"conv": (B, w-1, conv_dim), "ssm": (B, H,
    n, P) fp32} with L == 1 (decode: both written in place). Returns
    (out, cache).

    B and C come in cfg.mamba_groups groups, head h reading group h // (H /
    groups); the chunk scan runs each group's heads apart, inside a
    ``ssm.scan`` phase span. dt is clamped below at cfg.dt_min where it is
    set. Family "zamba2" ends in the gated RMSNorm (HF Zamba2's
    ``Zamba2RMSNormGated``): y silu(z) normed over each group's inner /
    groups channels in fp32 (eps 1e-5), times "gnorm", where the others
    take y silu(z)."""
    d, inner, H, P, n = mamba2_dims(cfg, d_model)
    G = cfg.mamba_groups
    B, L, _ = x.shape
    proj = x @ params["in_proj"]
    z, xBC, dt_raw = torch.split(proj, [inner, inner + 2 * G * n, H], -1)
    A = -torch.exp(params["a_log"])                                # (H,)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])            # (B,L,H)
    if cfg.dt_min:
        dt = dt.clamp(min=cfg.dt_min)

    new_cache = None
    if isinstance(cache, dict) and L == 1:
        xBC, conv_state = _causal_conv(xBC, params["conv_w"],
                                       params["conv_b"], cache["conv"])
        xi, Bm, Cm = torch.split(xBC, [inner, G * n, G * n], -1)
        xh = xi.reshape(B, 1, H, P).float()
        da = torch.exp(dt[:, 0] * A)                               # (B, H)
        xdt = xh[:, 0] * dt[:, 0, :, None]                         # (B,H,P)
        dBx = (_group_heads(Bm[:, 0].float(), G, H)[:, :, :, None]
               * xdt[:, :, None, :])
        h = cache["ssm"]                                           # (B,H,n,P)
        h.mul_(da[:, :, None, None]).add_(dBx)
        cache["conv"].copy_(conv_state)
        if G == 1:
            y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
        else:
            y = torch.einsum("bgn,bghnp->bghp",
                             Cm[:, 0].float().view(B, G, n),
                             h.view(B, G, H // G, n, P)).reshape(B, H, P)
        y = y[:, None] + params["d_skip"][None, None, :, None] * xh
        new_cache = cache
    else:
        xBC_raw = xBC
        xBC, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
        xi, Bm, Cm = torch.split(xBC, [inner, G * n, G * n], -1)
        xh = xi.reshape(B, L, H, P)
        with phase("ssm.scan"):
            if G == 1:
                y, hT = _ssd_chunk_scan(xh, Bm, Cm, dt, A)
            else:
                Hg = H // G
                parts = [_ssd_chunk_scan(
                    xh[:, :, g * Hg:(g + 1) * Hg], Bm[..., g * n:(g + 1) * n],
                    Cm[..., g * n:(g + 1) * n], dt[..., g * Hg:(g + 1) * Hg],
                    A[g * Hg:(g + 1) * Hg]) for g in range(G)]
                y = torch.cat([p[0] for p in parts], 2)
                hT = torch.cat([p[1] for p in parts], 1)
                del parts
        y = y + params["d_skip"][None, None, :, None] * xh.float()
        if cache is not None:                              # prefill: state
            W = cfg.ssm_conv
            pad = xBC_raw.new_zeros((B, W - 1, xBC_raw.shape[-1]))
            conv_state = torch.cat([pad, xBC_raw], 1)[:, -(W - 1):]
            new_cache = {"conv": conv_state, "ssm": hT}
    if cfg.family == "zamba2":
        yz = y.reshape(B, -1, G, inner // G) * F.silu(
            z.float()).view(B, -1, G, inner // G)
        yz = yz * torch.rsqrt(yz.square().mean(-1, keepdim=True) + 1e-5)
        y = (yz.view(B, -1, inner) * params["gnorm"].float()).to(x.dtype)
    else:
        y = y.reshape(B, -1, inner).to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], new_cache


def _group_heads(t: torch.Tensor, G: int, H: int) -> torch.Tensor:
    """A (B, G n) row of B or C as each head reads it: (B, 1, n) for one
    group (every head the same), else (B, H, n), head h group h // (H /
    G)."""
    Bsz, Gn = t.shape
    if G == 1:
        return t[:, None, :]
    n = Gn // G
    return t.view(Bsz, G, 1, n).expand(Bsz, G, H // G, n).reshape(Bsz, H, n)


# ===================================================================== #
# mLSTM (chunkwise-parallel with log-space stabilizers)
# ===================================================================== #
def mlstm_dims(cfg: ModelConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    inner = 2 * d
    H = cfg.n_heads
    P = inner // H          # value head dim
    Pk = max(P // 2, 4)     # q/k head dim
    return d, inner, H, P, Pk


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device,
               d_model: Optional[int] = None):
    d, inner, H, P, Pk = mlstm_dims(cfg, d_model)
    return {
        "w_v": dense_init(gen, d, inner, cfg.dtype, device),
        "w_z": dense_init(gen, d, inner, cfg.dtype, device),
        "w_q": dense_init(gen, d, H * Pk, cfg.dtype, device),
        "w_k": dense_init(gen, d, H * Pk, cfg.dtype, device),
        "w_gates": dense_init(gen, d, 2 * H, torch.float32, device),  # i, f
        "b_gates": torch.cat([torch.zeros((H,), device=device),
                              torch.full((H,), 3.0, device=device)]),
        "out_proj": dense_init(gen, inner, d, cfg.dtype, device),
    }


def _mlstm_chunk_scan(q, k, v, li, lf):
    """q, k: (B, L, H, Pk); v: (B, L, H, P); li, lf: (B, L, H) log gates.
    Returns h: (B, L, H, P) and the final (C, n, m), all fp32."""
    B, L, H, Pk = q.shape
    P = v.shape[-1]
    Lc = _chunk_len(L)
    masked = ~_causal_mask(Lc, q.device)[None, :, :, None]
    scale = 1.0 / math.sqrt(Pk)
    C = q.new_zeros((B, H, Pk, P), dtype=torch.float32)
    n = q.new_zeros((B, H, Pk), dtype=torch.float32)
    m = q.new_full((B, H), NEG_BIG, dtype=torch.float32)
    hs = []
    for qk_, kk, vk, lik, lfk in zip(*(t.float().split(Lc, 1)
                                       for t in (q, k, v, li, lf))):
        r = qk_.shape[1]                                    # Lc, or the tail
        cumf = torch.cumsum(lfk, 1)                         # (B, Lc, H)
        # log-weights: intra (t from s): cumf_t - cumf_s + li_s; inter:
        # cumf_t + m
        logw_intra = (cumf[:, :, None, :] - cumf[:, None, :, :]
                      + lik[:, None, :, :])                 # (B,Lc,Lc,H)
        logw_intra = logw_intra.masked_fill(masked[:, :r, :r], -math.inf)
        logw_inter = cumf + m[:, None, :]                   # (B, Lc, H)
        m_row = torch.maximum(logw_intra.amax(2), logw_inter)
        m_row = m_row.clamp_min(NEG_BIG)
        D = torch.exp(logw_intra - m_row[:, :, None, :])    # (B,Lc,Lc,H)
        w_inter = torch.exp(logw_inter - m_row)             # (B, Lc, H)
        qk = torch.einsum("blhp,bshp->blsh", qk_, kk) * scale
        scores = qk * D
        num = (torch.einsum("blsh,bshp->blhp", scores, vk)
               + torch.einsum("blhk,bhkp->blhp", qk_, C)
               * w_inter[..., None] * scale)
        den = (scores.sum(2)
               + torch.einsum("blhk,bhk->blh", qk_, n) * w_inter * scale)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_row))[..., None])
        # chunk-boundary state update
        cum_end = cumf[:, -1]                               # (B, H)
        lw_src = lik + cum_end[:, None, :] - cumf           # (B, Lc, H)
        m_next = torch.maximum(cum_end + m, lw_src.amax(1))
        w_old = torch.exp(cum_end + m - m_next)             # (B, H)
        w_src = torch.exp(lw_src - m_next[:, None, :])      # (B, Lc, H)
        kw = kk * w_src[..., None]
        C = (w_old[:, :, None, None] * C
             + torch.einsum("bshk,bshp->bhkp", kw, vk))
        n = w_old[:, :, None] * n + kw.sum(1)
        m = m_next
    return torch.cat(hs, 1), (C, n, m)


def apply_mlstm(params, cfg: ModelConfig, x, cache=None,
                d_model: Optional[int] = None):
    """x: (B, L, d). cache: None, "init" (prefill) or {"C": (B, H, Pk, P),
    "n": (B, H, Pk), "m": (B, H)} fp32 with L == 1 (decode: written in
    place). Returns (out, cache)."""
    d, inner, H, P, Pk = mlstm_dims(cfg, d_model)
    B, L, _ = x.shape
    v = (x @ params["w_v"]).reshape(B, L, H, P)
    z = x @ params["w_z"]
    q = (x @ params["w_q"]).reshape(B, L, H, Pk)
    k = (x @ params["w_k"]).reshape(B, L, H, Pk)
    gates = (x.float() @ params["w_gates"]) + params["b_gates"]
    li, lf = gates[..., :H], F.logsigmoid(gates[..., H:])

    new_cache = None
    if isinstance(cache, dict) and L == 1:
        C, n, m = cache["C"], cache["n"], cache["m"]
        lik, lfk = li[:, 0], lf[:, 0]                        # (B, H)
        m_next = torch.maximum(lfk + m, lik)
        w_old = torch.exp(lfk + m - m_next)
        w_new = torch.exp(lik - m_next)
        kf = k[:, 0].float()
        vf = v[:, 0].float()
        qf = q[:, 0].float() / math.sqrt(Pk)
        # C <- w_old C + (w_new k) v^T, n <- w_old n + w_new k, in place
        kw = kf * w_new[:, :, None]                          # (B, H, Pk)
        C.mul_(w_old[:, :, None, None])
        C.view(B * H, Pk, P).baddbmm_(kw.reshape(B * H, Pk, 1),
                                      vf.reshape(B * H, 1, P))
        n.mul_(w_old[:, :, None]).add_(kw)
        m.copy_(m_next)
        num = torch.bmm(qf.reshape(B * H, 1, Pk),
                        C.view(B * H, Pk, P)).view(B, H, P)
        den = (qf * n).sum(-1)                               # (B, H)
        h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
        h = h[:, None]
        new_cache = cache
    else:
        h, (Ct, nt, mt) = _mlstm_chunk_scan(q, k, v, li, lf)
        if cache is not None:
            new_cache = {"C": Ct, "n": nt, "m": mt}
    y = h.reshape(B, -1, inner).to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], new_cache


# ===================================================================== #
# sLSTM (sequential scan; recurrent weights make it non-parallelizable)
# ===================================================================== #
def init_slstm(gen: torch.Generator, cfg: ModelConfig, device,
               d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    H = cfg.n_heads
    dh = d // H
    w_in = dense_init(gen, d, 4 * d, cfg.dtype, device)    # z, i, f, o
    r = torch.randn((4, H, dh, dh), generator=gen,
                    device=device) / math.sqrt(dh)
    return {
        "w_in": w_in,
        "r": r,
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, d, d, cfg.dtype, device),
    }


def _slstm_scan(pre_all, r, h, c, n, m):
    """The sLSTM's time loop. pre_all (L, H, B, 4 dh): each step's input
    pre-activations; r (H, dh, 4 dh); h, c, n, m (H, B, dh) the state.
    Returns the outputs (H, B, L, dh) and the final state."""
    hs = []
    for pre_t in pre_all.unbind(0):
        zi, ii, fi, oi = (pre_t + torch.bmm(h, r)).chunk(4, -1)
        fm = fi + m
        m_new = torch.maximum(fm, ii)
        i_g = torch.exp(ii - m_new)
        f_g = torch.exp(fm - m_new)
        c = f_g * c + i_g * torch.tanh(zi)
        n = f_g * n + i_g
        h = torch.sigmoid(oi) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 2), (h, c, n, m)


def apply_slstm(params, cfg: ModelConfig, x, cache=None,
                d_model: Optional[int] = None):
    """x: (B, L, d). cache: None, "init" (prefill) or {"h", "c", "n", "m":
    (B, d)} fp32 (decode from that state: written in place). Returns (out,
    cache).

    The loop keeps the state head-major, (H, B, dh), so that each step's
    recurrent input is one `bmm` of h against r laid out (H, dh, 4 dh): the
    reference's four einsums "bhd,hde->bhe" over r[g], concatenated z, i,
    f, o."""
    d = d_model or cfg.d_model
    H = cfg.n_heads
    dh = d // H
    B, L, _ = x.shape
    pre_all = (x @ params["w_in"]).float() + params["b"]     # (B, L, 4d)
    # (L, H, B, 4 dh): gate g of head h at [..., g * dh:(g + 1) * dh]
    pre_all = pre_all.view(B, L, 4, H, dh).permute(1, 3, 0, 2, 4).reshape(
        L, H, B, 4 * dh)
    r = params["r"].permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)

    def heads(t):                                    # (B, d) -> (H, B, dh)
        return t.view(B, H, dh).transpose(0, 1)

    if isinstance(cache, dict):
        h, c, n, m = (heads(cache[k]) for k in ("h", "c", "n", "m"))
    else:
        h = c = n = x.new_zeros((H, B, dh), dtype=torch.float32)
        m = x.new_full((H, B, dh), NEG_BIG, dtype=torch.float32)
    hs, (h, c, n, m) = _slstm_scan(pre_all, r, h, c, n, m)
    y = hs.permute(1, 2, 0, 3).reshape(B, L, d).to(x.dtype)
    new_cache = None
    if isinstance(cache, dict):
        for key, t in zip(("h", "c", "n", "m"), (h, c, n, m)):
            heads(cache[key]).copy_(t)
        new_cache = cache
    elif cache is not None:
        new_cache = {key: t.transpose(0, 1).reshape(B, d)
                     for key, t in zip(("h", "c", "n", "m"), (h, c, n, m))}
    return y @ params["out_proj"], new_cache
