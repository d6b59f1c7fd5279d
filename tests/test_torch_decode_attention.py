"""The decode-attention wrapper (kernels/decode_attention.py) on the CPU.

The CUDA kernels run only on a card (tests/test_torch_gpu.py and
chip_smoke.py hold them against an fp32 computation and the plain
version). Here:

* on CPU tensors the wrapper returns the reference's decode call,
  `gqa_attention` over the whole cache under its mask, bit for bit, at
  every config's (hd, G), kv_valid 1, a middle value and L, and past a
  ring's wrap; the launch counter does not move;
* `apply_attention`'s decode step on the CPU is bitwise the step it
  replaced (the k/v write, then that call), the cache too;
* meta inputs launch nothing and record the kernels' work over the cache;
* the wrapper raises on a head dim the kernels lack, on a dtype mismatch,
  on a cache whose last dim (or slot stride) is strided, on bad shapes and
  on more query heads a KV head than the kernels serve;
* the warps that split a KV head's filled slots, a function of the shapes
  and the card alone, finish soonest by the rule's own measure.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels.ref import gqa_attention  # noqa: E402
from repro_torch.models.api import init_model  # noqa: E402
from repro_torch.models.attention import (apply_attention,  # noqa: E402
                                          init_attention)
from repro_torch.models.layers import apply_rope  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

B, L, KV = 2, 96, 2


def _shapes():
    """(H / KV, hd, dtype) of every config with attention, and Zamba2-7B
    as published: G 1, 3, 4, 6, 8, 48 at hd 64, 112, 128, 224."""
    out = set()
    for arch in list(ARCH_IDS) + ["zamba2-7b-instruct"]:
        cfg = get_config(arch)
        if cfg.block_kind == "xlstm":
            continue
        out.add((cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim,
                 cfg.dtype))
    return sorted(out, key=lambda s: (s[0], s[1], str(s[2])))


SHAPES = _shapes()


def _inputs(G, hd, dtype, seed=0, length=L):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, KV * G, hd), generator=g).to(dtype)
    k = torch.randn((B, length, KV, hd), generator=g).to(dtype)
    v = torch.randn((B, length, KV, hd), generator=g).to(dtype)
    return q, k, v


def _parent_decode(q, k, v, index, scale=None):
    """The parent's decode call, as `apply_attention` made it."""
    kv_valid = torch.clamp(index + 1, max=k.shape[1])
    return gqa_attention(q, k, v, causal=False, sliding_window=0,
                         kv_len_valid=kv_valid, q_start=index, scale=scale)


def test_the_configs_cover_every_head_dim_and_group():
    assert {s[0] for s in SHAPES} == {1, 3, 4, 6, 8, 48}
    assert {s[1] for s in SHAPES} == set(da.HEAD_DIMS)


@pytest.mark.parametrize("index", [0, 40, L - 1, L + 37])
@pytest.mark.parametrize("G,hd,dtype", SHAPES)
def test_cpu_is_the_reference_decode_bitwise(G, hd, dtype, index):
    """kv_valid 1, a middle value, L, and a wrapped ring (kv_valid L); both
    dtypes; the launch counter stays."""
    before = dict(da.launches)
    for dt in (dtype, torch.float32):
        q, k, v = _inputs(G, hd, dt, seed=G + hd)
        pos = torch.tensor(index)
        got = ops.decode_attention_op(q, k, v, pos)
        want = _parent_decode(q, k, v, pos)
        assert got.dtype == dt and got.shape == q.shape
        assert torch.equal(got, want)
    assert da.launches == before


def test_cpu_passes_the_scale_through():
    q, k, v = _inputs(1, 224, torch.bfloat16, seed=3)
    pos = torch.tensor(50)
    scale = 112 ** -0.5
    got = da.decode_attention(q, k, v, pos, scale=scale)
    assert torch.equal(got, _parent_decode(q, k, v, pos, scale=scale))
    assert not torch.equal(got, _parent_decode(q, k, v, pos))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-vl-2b",
                                  "granite-20b", "zamba2-7b-instruct"])
def test_apply_attention_decode_is_its_parents_bitwise(arch):
    """The decode branch: the k/v written at slot index % L in place, then
    the reference's call; output and cache bitwise the parent's, fp32 and
    bf16, before and after the ring wraps."""
    full = get_config(arch)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(
            full.smoke(), n_heads=full.n_heads, n_kv_heads=full.n_kv_heads,
            head_dim=full.resolved_head_dim, dtype=dtype, mrope_sections=())
        d = cfg.d_model
        gen = torch.Generator().manual_seed(7)
        params = init_attention(gen, cfg, "cpu")
        hd, KVc = cfg.resolved_head_dim, cfg.n_kv_heads
        scale = (hd / 2) ** -0.5 if arch == "zamba2-7b-instruct" else None
        cache = {n: torch.randn((B, 32, KVc, hd), generator=gen).to(dtype)
                 for n in ("k", "v")}
        mine = {n: t.clone() for n, t in cache.items()}
        for index in (5, 31, 45):
            x = torch.randn((B, 1, d), generator=gen).to(dtype)
            pos = torch.tensor(index)
            positions = pos.view(1, 1).expand(B, 1)
            got, new = apply_attention(params, cfg, x, positions, mine, pos,
                                       scale=scale)
            # the parent's branch, written out
            q = (x @ params["wq"]).reshape(B, 1, cfg.n_heads, hd)
            k = (x @ params["wk"]).reshape(B, 1, KVc, hd)
            v = (x @ params["wv"]).reshape(B, 1, KVc, hd)
            q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
            slot = (pos % 32).view(1)
            cache["k"].index_copy_(1, slot, k.to(dtype))
            cache["v"].index_copy_(1, slot, v.to(dtype))
            want = _parent_decode(q, cache["k"], cache["v"], pos, scale)
            want = want.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
            assert new is mine
            assert torch.equal(got, want)
            assert all(torch.equal(mine[n], cache[n]) for n in ("k", "v"))


@pytest.mark.parametrize("G,hd,dtype", [(8, 128, torch.bfloat16),
                                        (1, 224, torch.bfloat16),
                                        (48, 128, torch.float32)])
def test_meta_records_the_work_and_launches_nothing(G, hd, dtype):
    q, k, v = (t.to("meta") for t in _inputs(G, hd, dtype))
    pos = torch.empty((), dtype=torch.int64, device="meta")
    before = dict(da.launches)
    with cost.counting() as tally:
        out = ops.decode_attention_op(q, k, v, pos)
    assert out.is_meta and out.shape == q.shape and out.dtype == dtype
    assert da.launches == before
    elt = q.element_size()
    want = cost.decode_attention_work(B, KV * G, KV, L, hd, elt)
    assert tally["decode_attention"] == {"calls": 1, "bytes": want[0],
                                         "flops": want[1]}
    assert want == (2 * B * KV * L * hd * elt + 2 * B * KV * G * hd * elt,
                    4 * B * KV * G * L * hd)


def test_generate_on_the_cpu_moves_no_counter():
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    before = dict(da.launches)
    eng.generate({"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                          generator=torch.Generator()
                                          .manual_seed(1))}, n_new=3)
    assert da.launches == before


def test_raises_on_a_head_dim_the_kernels_lack():
    q, k, v = (t.to("meta") for t in _inputs(2, 96, torch.bfloat16))
    with pytest.raises(ValueError, match="hd in"):
        da.decode_attention(q, k, v, torch.empty((), dtype=torch.int64,
                                                 device="meta"))


def test_raises_on_a_dtype_mismatch():
    q, k, v = _inputs(2, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        da.decode_attention(q, k.float(), v.float(), torch.tensor(3))
    with pytest.raises(TypeError, match="one dtype"):
        da.decode_attention(q.to("meta"), k.to("meta"),
                            v.float().to("meta"), torch.tensor(3))


def test_raises_on_a_strided_cache():
    q, _, _ = _inputs(2, 128, torch.bfloat16)
    wide = torch.empty((B, L, KV, 256), dtype=torch.bfloat16, device="meta")
    k = wide[..., ::2]
    assert k.shape == (B, L, KV, 128) and k.stride(3) == 2
    with pytest.raises(ValueError, match="through its strides"):
        da.decode_attention(q.to("meta"), k, k, torch.empty(
            (), dtype=torch.int64, device="meta"))
    # a slot stride off 16 bytes
    odd = torch.empty((B, L, KV, 129), dtype=torch.bfloat16,
                      device="meta")[..., :128]
    with pytest.raises(ValueError, match="through its strides"):
        da.decode_attention(q.to("meta"), odd, odd, torch.empty(
            (), dtype=torch.int64, device="meta"))


def test_raises_on_bad_shapes_and_groups():
    q, k, v = _inputs(2, 128, torch.float32)
    with pytest.raises(ValueError, match="caches"):
        da.decode_attention(q[:, :, :3], k, v, torch.tensor(1))
    with pytest.raises(ValueError, match=r"\(B, 1, H, hd\)"):
        da.decode_attention(torch.cat([q, q], 1), k, v, torch.tensor(1))
    big = torch.empty((B, 1, 130, 128), device="meta")
    one = torch.empty((B, L, 1, 128), device="meta")
    with pytest.raises(ValueError, match="at most"):
        da.decode_attention(big, one, one, torch.empty(
            (), dtype=torch.int64, device="meta"))


def _fits(per_warp_kb, sms=132, smem_kb=227, warps_cap=64):
    """Blocks of 1 .. MAX_WARPS warps a card holds at once when a warp takes
    per_warp_kb of shared memory: what the occupancy API gives where
    shared memory sets it."""
    return tuple(sms * min(int(smem_kb // (w * per_warp_kb)),
                           warps_cap // w) for w in
                 range(1, da.MAX_WARPS + 1))


@pytest.mark.parametrize("per_warp_kb", [14.0, 26.7, 33.0, 58.0])
@pytest.mark.parametrize("pairs", [1, 8, 128, 1024, 6144])
@pytest.mark.parametrize("L_", [1, 64, 256, 1024, 32768])
def test_warps_finish_soonest(per_warp_kb, pairs, L_):
    """W fits the card, is at most MAX_WARPS and L / MIN_PART, and no
    other such W finishes sooner by 2% or more."""
    fits = _fits(per_warp_kb)
    W = da.warps(fits, pairs, L_)
    top = min(da.MAX_WARPS, max(1, L_ // da.MIN_PART))
    assert 1 <= W <= top and fits[W - 1] > 0

    def cost(n):
        return -(-pairs // fits[n - 1]) / min(n, da.SATURATE)
    assert all(cost(n) >= 0.98 * cost(W) for n in range(1, top + 1)
               if fits[n - 1] > 0)


def test_warps_at_the_serve_cells():
    """The MoE cell's 128 (b, KV head) blocks, 26 KB a warp: one wave of
    four-warp blocks, one an SM; Zamba2's 1,024, 33 KB a warp: three warps,
    two blocks an SM, four waves."""
    assert da.warps(_fits(26.0), 32 * 4, 1024) == 4
    assert da.warps(_fits(33.0), 32 * 32, 1024) == 3


def test_warps_raises_where_no_block_fits():
    with pytest.raises(RuntimeError, match="no block"):
        da.warps((0,) * da.MAX_WARPS, 4, 1024)
