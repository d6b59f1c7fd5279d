"""The optimizer's fused kernels (`repro_torch.kernels.adamw`, csrc/adamw.cu)
against their plain versions in `repro_torch.optim.optimizers`.

On the CPU: the chunk table the wrappers build (every element of every leaf
exactly once, chunks aligned for the kernels' 16-byte vectors), the leaf
table handed to the kernels (lengths, first chunks, dtype bits), the
groups of leaves a launch takes, the wrappers' checks, the constants shared
with the CUDA source, and that CPU leaves take the plain versions. On the
card (marked gpu; each test skips inside its fixture without CUDA): the
update's p, m and v bitwise the plain version's, the norm against a float64
norm and bitwise over two calls, the launches a step, a graph replay, and
the checks that refuse a leaf. The file imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_adamw_kernel.py
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as fa  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

C = fa.CHUNK
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
        "kernels" / "csrc" / "adamw.cu")

# leaf lengths: ragged tails, 0-d leaves (one element), leaves of no
# elements, whole chunks and one element past them
NUMELS = [
    [1],
    [7, 1, 9],
    [C],
    [C + 1, 1, 3 * C - 5],
    [0, 5, 0, 2 * C, 1, 0],
    [C - 1, C, C + 1, 8 * C + 3, 17],
]


@pytest.mark.parametrize("numels", NUMELS)
def test_chunk_table_covers_every_element_once(numels):
    table = fa.chunk_table(numels)
    firsts, n_chunks = fa.chunk_starts(numels)
    assert len(table) == n_chunks == sum(-(-n // C) for n in numels)
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    for chunk, (leaf, off, length) in enumerate(table):
        assert 0 < length <= C
        # a chunk starts on a multiple of 8 elements: 16 bytes in bf16
        assert off % C == 0 and off % 8 == 0
        assert firsts[leaf] <= chunk
        seen[leaf][off:off + length] += 1
    for s in seen:
        assert (s == 1).all()
    # chunks rise leaf after leaf, as a block of the kernels walks them
    assert [t[0] for t in table] == sorted(t[0] for t in table)


@pytest.mark.parametrize("g_dtype,p_dtype,bits", [
    (torch.float32, torch.float32, 0), (torch.bfloat16, torch.float32, 1),
    (torch.float32, torch.bfloat16, 2), (torch.bfloat16, torch.bfloat16, 3),
    (torch.bfloat16, None, 1), (torch.float32, None, 0)])
def test_kinds_bits(g_dtype, p_dtype, bits):
    assert fa.kinds(g_dtype, p_dtype) == bits


def _leaves(shapes, dtypes):
    return [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]


def test_leaf_table_holds_mixed_dtypes_and_ragged_leaves():
    """The table the kernels get: each leaf's pointers, length, first chunk
    and dtype bits, for mixed bf16 and fp32 params and grads, a 0-d leaf
    and ragged lengths."""
    shapes = [(), (3, 5), (C + 3,), (2, C), (9,)]
    g_dt = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16,
            torch.bfloat16]
    p_dt = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
            torch.bfloat16]
    g, p = _leaves(shapes, g_dt), _leaves(shapes, p_dt)
    m, v = (_leaves(shapes, [torch.float32] * 5) for _ in range(2))
    fa.check_leaves(g, p, m, v)
    arr, n_chunks = fa._table(g, p, m, v)
    assert ctypes.sizeof(fa._Leaf) == 48
    assert len(arr) == 5 and n_chunks == 1 + 1 + 2 + 2 + 1
    assert [a.first for a in arr] == [0, 1, 2, 4, 6]
    assert [a.n for a in arr] == [1, 15, C + 3, 2 * C, 9]
    assert [a.kinds for a in arr] == [0, 3, 2, 1, 3]
    for a, *ts in zip(arr, g, p, m, v):
        assert [a.g, a.p, a.m, a.v] == [t.data_ptr() for t in ts]
    arr, n_chunks = fa._table(g)         # the norm's: gradients alone
    assert n_chunks == 7 and all(a.p is None and a.m is None for a in arr)


@pytest.mark.parametrize("n_leaves", [1, 63, 64, 65, 130])
def test_groups_take_every_leaf_with_elements_in_order(n_leaves):
    numels = [0 if i % 7 == 3 else i + 1 for i in range(n_leaves)]
    parts = fa.groups(numels)
    assert all(0 < len(p) <= fa.MAX_LEAVES for p in parts)
    assert [i for p in parts for i in p] == [i for i, n in enumerate(numels)
                                             if n]


def test_source_constants_match_the_wrapper():
    src = CSRC.read_text()
    assert re.search(r"constexpr int kChunk = 1 << (\d+);", src).group(1) \
        == str(C.bit_length() - 1)
    assert f"constexpr int kMaxLeaves = {fa.MAX_LEAVES};" in src
    assert "static_assert(sizeof(Leaf) == 48" in src


def _refused(g, p=None, m=None, v=None):
    with pytest.raises((ValueError, TypeError)):
        fa.check_leaves(g, p, m, v)


def test_checks_refuse_what_the_kernels_cannot_take():
    base = torch.zeros(4, 6, dtype=torch.bfloat16)
    ok = [torch.zeros(4, 6, dtype=torch.bfloat16)]
    f32 = [torch.zeros(4, 6)]
    fa.check_leaves(ok, ok, f32, f32)
    _refused([base.t()])                               # not contiguous
    _refused([torch.zeros(25, dtype=torch.bfloat16)[1:]])   # off 16 bytes
    _refused(ok, [base.t().contiguous()], f32, f32)    # shapes differ
    _refused(ok, ok, ok, f32)                          # m not fp32
    _refused([torch.zeros(4, 6, dtype=torch.float16)])  # dtype
    _refused(ok, ok + ok, f32, f32)                    # leaf counts
    _refused(ok + [torch.zeros(3, device="meta")])     # two devices


def _tree(rng, dtype):
    return {"a": torch.from_numpy(rng.standard_normal((5, 7, 3))
                                  .astype(np.float32)).to(dtype),
            "b": [torch.from_numpy(rng.standard_normal(11)
                                   .astype(np.float32)).to(dtype)],
            "c": torch.tensor(0.5, dtype=dtype)}


def test_cpu_leaves_take_the_plain_versions():
    """On the CPU `update_` is `adamw_plain_` and `global_norm` the plain
    sum, bit for bit, and no kernel launches."""
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.bfloat16):
        params = _tree(rng, dtype)
        grads = tree_map(lambda p: torch.randn_like(p.float()).to(dtype),
                         params)
        sched = topt.cosine_schedule(1e-2, 10, warmup=2)
        opt = topt.adamw(sched, weight_decay=0.1)
        a, b = params, tree_map(torch.clone, params)
        sa, sb = opt.init(a), opt.init(b)
        before = dict(fa.launches)
        gn = topt.global_norm(grads)
        assert torch.equal(gn, topt.global_norm_plain(grads))
        scale = topt.clip_scale(gn, 1.0)
        opt.update_(grads, sa, a, scale)
        topt.adamw_plain_(grads, sb, b, scale, lr=sched, weight_decay=0.1)
        assert fa.launches == before
        for x, y in zip(tree_leaves((a, sa["m"], sa["v"])),
                        tree_leaves((b, sb["m"], sb["v"]))):
            assert torch.equal(x, y)
        assert int(sa["step"]) == int(sb["step"]) == 1


def test_strided_gradients_are_copied_dense_and_others_passed():
    """What the CUDA paths hand the kernels: a gradient in another layout
    (an einsum's backward gives musicgen's per-codebook head (d, nq, V) in
    memory) is copied to a contiguous one of the same values; a contiguous
    one is the same tensor."""
    strided = torch.randn(256, 4, 32).permute(1, 0, 2)
    dense = torch.randn(4, 256, 32)
    out = topt._dense({"head": strided, "w": [dense]})
    assert out[0].is_contiguous() and torch.equal(out[0], strided)
    assert out[1] is dense


@pytest.mark.parametrize("cell,leaves,params", [
    ("qwen3moe-l4-train-b4s2048", 25, 3_193_916_672),
    ("qwen2vl-train-b4s2048", 22, 1_792_766_976)])
def test_smoke_leaf_sets_and_launches_a_step(cell, leaves, params):
    """chip_smoke.py's phase 3b builds each train cell's leaf set from its
    configuration file alone (both models on meta), and its training
    phases expect one sumsq and one adamw launch a group of `MAX_LEAVES`
    leaves and one sumsq_finish a step."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    got, hp = chip_smoke.adamw_cell(cell)
    numels = [int(np.prod(shape)) for shape, _ in got]
    assert (len(got), sum(numels)) == (leaves, params)
    assert {dt for _, dt in got} <= {torch.bfloat16, torch.float32}
    assert hp["lr"] > 0 and hp["grad_clip"] > 0
    assert chip_smoke.optimizer_launches(numels) == {
        "sumsq": 1, "sumsq_finish": 1, "adamw": 1}
    assert chip_smoke.optimizer_launches(numels * 3, clip=False) == {
        "sumsq": 0, "sumsq_finish": 0, "adamw": 2}


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# leaf shapes on the card: a 0-d leaf, ragged tails, a leaf of several
# chunks with a ragged last one, one of whole chunks
CARD_SHAPES = [(), (7,), (5, 7, 3), (3, C + 13), (2, C), (1000, 129)]


def _card_tree(device, p_dtype, g_dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    params = [(torch.randn(s, generator=g, device=device)).to(p_dtype)
              for s in CARD_SHAPES]
    grads = [(torch.randn(s, generator=g, device=device) * 3).to(g_dtype)
             for s in CARD_SHAPES]
    return params, grads


@pytest.mark.gpu
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lr", ["cosine", "constant"])
def test_update_is_the_plain_version_bitwise(cuda, p_dtype, g_dtype, lr):
    """Three steps of the fused update against `adamw_plain_` from the
    same state, both given the plain version's clip factor: p, m and v
    equal bit for bit (weight decay 0.1; a cosine schedule's 0-d rate or a
    float one; the clip factor at 1.0 and 1e3, so it scales and does
    not)."""
    sched = (topt.cosine_schedule(1e-2, 10, warmup=2) if lr == "cosine"
             else 3e-4)
    opt = topt.adamw(sched, weight_decay=0.1)
    params, _ = _card_tree(cuda, p_dtype, g_dtype, seed=1)
    ref = [t.clone() for t in params]
    state, ref_state = opt.init(params), opt.init(ref)
    for i in range(3):
        _, grads = _card_tree(cuda, p_dtype, g_dtype, seed=10 + i)
        scale = topt.clip_scale(topt.global_norm_plain(grads),
                                1.0 if i != 1 else 1e3)
        before = fa.launches["adamw"]
        opt.update_(grads, state, params, scale)
        assert fa.launches["adamw"] == before + 1
        topt.adamw_plain_(grads, ref_state, ref, scale, lr=sched,
                          weight_decay=0.1)
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves((params, state["m"], state["v"])),
                    tree_leaves((ref, ref_state["m"], ref_state["v"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state["step"]) == int(ref_state["step"]) == 3


@pytest.mark.gpu
def test_update_without_clip_factor_is_the_plain_version_bitwise(cuda):
    opt = topt.adamw(1e-3)
    params, grads = _card_tree(cuda, torch.bfloat16, torch.bfloat16, seed=3)
    ref = [t.clone() for t in params]
    state, ref_state = opt.init(params), opt.init(ref)
    opt.update_(grads, state, params)
    topt.adamw_plain_(grads, ref_state, ref, lr=1e-3)
    for a, b in zip(tree_leaves((params, state["m"], state["v"])),
                    tree_leaves((ref, ref_state["m"], ref_state["v"]))):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_block_walks_many_chunks_across_leaves(cuda, monkeypatch):
    """A grid of 3 blocks, so that each block walks about 20 chunks round
    robin and crosses from leaf to leaf (the kernels' carry-over of the
    leaf a chunk is in): two steps of the update give `adamw_plain_`'s
    bits, over mixed bf16 and fp32 params and grads, and the norm is
    within 1e-5 of float64 and the same bits twice."""
    dev = torch.empty(0, device=cuda).device
    for kernel in ("adamw", "sumsq"):
        monkeypatch.setitem(fa._grids, (dev, kernel), 3)
    assert fa.grid(dev, "adamw", 1000) == fa.grid(dev, "sumsq", 1000) == 3
    shapes = CARD_SHAPES + [(3_000_017,), (5, C - 3), (11,)]
    gen = torch.Generator(device=dev).manual_seed(8)
    dts = (torch.bfloat16, torch.float32)
    params = [torch.randn(s, generator=gen, device=dev).to(dts[i % 2])
              for i, s in enumerate(shapes)]
    grads = [(torch.randn(s, generator=gen, device=dev) * 1e-2).to(
        dts[(i // 2) % 2]) for i, s in enumerate(shapes)]
    assert fa.chunk_starts([g.numel() for g in grads])[1] > 20 * 3
    gn, again = topt.global_norm(grads), topt.global_norm(grads)
    exact = float(torch.stack([g.double().square().sum()
                               for g in grads]).sum().sqrt())
    assert abs(float(gn) - exact) <= 1e-5 * exact
    assert torch.equal(gn, again)
    sched = topt.cosine_schedule(1e-2, 10, warmup=2)
    opt = topt.adamw(sched, weight_decay=0.1)
    ref = [t.clone() for t in params]
    state, ref_state = opt.init(params), opt.init(ref)
    scale = topt.clip_scale(topt.global_norm_plain(grads), 1.0)
    for _ in range(2):
        opt.update_(grads, state, params, scale)
        topt.adamw_plain_(grads, ref_state, ref, scale, lr=sched,
                          weight_decay=0.1)
    torch.cuda.synchronize()
    for a, b in zip(params + state["m"] + state["v"],
                    ref + ref_state["m"] + ref_state["v"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_norm_is_close_to_float64_and_repeats_bitwise(cuda, g_dtype):
    _, grads = _card_tree(cuda, torch.float32, g_dtype, seed=4)
    grads.append((torch.randn(3_000_017, device=cuda) * 1e-2).to(g_dtype))
    before = dict(fa.launches)
    gn = topt.global_norm(grads)
    again = topt.global_norm(grads)
    assert fa.launches["sumsq"] == before["sumsq"] + 2
    assert fa.launches["sumsq_finish"] == before["sumsq_finish"] + 2
    exact = float(torch.stack([g.double().square().sum()
                               for g in grads]).sum().sqrt())
    assert gn.dtype == torch.float32 and gn.shape == ()
    assert abs(float(gn) - exact) <= 1e-5 * exact
    assert torch.equal(gn, again)


@pytest.mark.gpu
def test_a_step_launches_three_kernels_and_more_leaves_more(cuda):
    """norm (2) + update (1) for up to MAX_LEAVES leaves; one more of the
    norm's first kernel and of the update per further group."""
    for n_leaves, groups in ((5, 1), (fa.MAX_LEAVES + 3, 2)):
        params = [torch.randn(i % 5 + 1, 3, device=cuda)
                  for i in range(n_leaves)]
        grads = [torch.randn_like(p) for p in params]
        opt = topt.adamw(1e-3)
        state = opt.init(params)
        fa.reset_launches()
        opt.update_(grads, state, params,
                    topt.clip_scale(topt.global_norm(grads), 1.0))
        assert fa.launches == {"sumsq": groups, "sumsq_finish": 1,
                               "adamw": groups}
        exact = float(torch.cat([g.double().flatten() for g in grads])
                      .norm())
        gn = float(topt.global_norm(grads))
        assert abs(gn - exact) <= 1e-5 * exact


@pytest.mark.gpu
def test_kernels_replay_in_a_cuda_graph(cuda):
    """The leaf table travels as a kernel parameter: a captured norm and
    update replay as they run eagerly."""
    params, grads = _card_tree(cuda, torch.bfloat16, torch.bfloat16, seed=6)
    m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    eager = [t.clone() for t in params + m + v]
    lr = torch.tensor(1e-3, device=cuda)
    bc1, bc2 = torch.tensor(0.1, device=cuda), torch.tensor(1e-3, device=cuda)

    def run(ps, ms, vs):
        gn = fa.global_norm(grads)
        fa.adamw_(grads, ps, ms, vs, lr, bc1, bc2, topt.clip_scale(gn, 1.0),
                  0.9, 0.999, 1e-8, 0.0)
        return gn
    n = len(params)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn_eager = run(eager[:n], eager[n:2 * n], eager[2 * n:])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gn_graph = run(params, m, v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gn_graph, gn_eager)
    for a, b in zip(params + m + v, eager):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_card_refuses_unaligned_or_strided_leaves(cuda):
    """The kernels refuse a strided or misaligned leaf, and so does the
    optimizer for params, m and v (written in place) and for a misaligned
    gradient. A strided gradient, as autograd may hand one, is copied
    first: the norm and the step are those of its contiguous copy, bit for
    bit."""
    opt = topt.adamw(1e-3)
    base = torch.randn(33, 8, device=cuda, dtype=torch.bfloat16)
    for bad in (base.t(), base.flatten()[1:]):
        grads = [torch.randn_like(bad)]
        with pytest.raises(ValueError):
            fa.global_norm([bad])
        state = opt.init([bad])
        with pytest.raises(ValueError):
            opt.update_(grads, state, [bad])
        with pytest.raises(ValueError):
            opt.update_([bad], opt.init(grads), grads)
    with pytest.raises(ValueError):
        topt.global_norm([base.flatten()[1:]])
    strided = base.t()
    assert torch.equal(topt.global_norm([strided]),
                       topt.global_norm([strided.contiguous()]))
    params = [torch.randn(8, 33, device=cuda, dtype=torch.bfloat16)]
    ref = [params[0].clone()]
    state, ref_state = opt.init(params), opt.init(ref)
    opt.update_([strided], state, params)
    opt.update_([strided.contiguous()], ref_state, ref)
    for a, b in zip(params + state["m"] + state["v"],
                    ref + ref_state["m"] + ref_state["v"]):
        assert torch.equal(a, b)
