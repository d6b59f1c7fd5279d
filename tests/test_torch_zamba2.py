"""Zamba2 as published (family "zamba2", `models/zamba2.py`) on the CPU, at
a tiny configuration with the published shapes: 2 shared blocks taken in
turn, B and C in 2 groups, LoRA adapters of rank 8 on gate_up, the calls at
an irregular list of layers, hd = 2 d / heads, and prompts of two chunks
of the SSD scan and a ragged tail.

The program is held to the benchmark's plain reference
(`portbench/reference/zamba2.py`: fp32, the recurrence position by
position, full softmax attention), made from the same seeded weight
groups, and the reference to HF transformers' `Zamba2ForCausalLM` (its
torch path, eager attention, one chunk) with the weights copied across.
Tolerances: atol and rtol 2e-4 on fp32 logits (the chunked scan and the
recurrence sum in other orders). The scans' ragged last chunk is held to
the same positions of a longer prompt, whose chunks are whole.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench import harness  # noqa: E402
from portbench.reference import zamba2 as Z  # noqa: E402
from repro_torch.models import api, ssm  # noqa: E402
from repro_torch.serve import ServeEngine, make_decode_step  # noqa: E402
from repro_torch.serve.engine import _load_prefill  # noqa: E402
from repro_torch.utils.pytree import tree_map  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
SEED = 11
P = 300            # two chunks of 128 and a tail of 44

TINY = {"num_hidden_layers": 7, "hidden_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "attention_head_dim": 64, "intermediate_size": 96,
        "vocab_size": 97, "mamba_d_state": 8, "mamba_d_conv": 4,
        "mamba_expand": 2, "mamba_headdim": 64, "n_mamba_heads": 4,
        "mamba_ngroups": 2, "num_mem_blocks": 2,
        "hybrid_layer_ids": [1, 2, 5], "adapter_rank": 8,
        "rms_norm_eps": 1e-5, "rope_theta": 10000, "time_step_min": 0.001,
        "time_step_max": 0.1, "time_step_floor": 1e-4,
        "tie_word_embeddings": True, "torch_dtype": "float32",
        "use_mem_rope": True, "use_shared_attention_adapter": False}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and the
    recurrence's many small operations slow down many times over when every
    worker's thread pool spins on every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    spec = Z.from_config(TINY)
    job = harness.load_module("jobs", "serve_zamba2")
    cfg = job.program_config(spec, "tiny-zamba2")
    params = Z.program_tree(spec, SEED, "model", "cpu")
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, spec.vocab, (2, P + 8)))
    return spec, cfg, params, tok


def _ref_logits(spec, tok):
    return Z.forward_logits(spec, SEED, "model", tok, "cpu")


def test_prefill_and_forward_match_the_reference(tiny):
    spec, cfg, params, tok = tiny
    want = _ref_logits(spec, tok[:, :P])
    got, cache = api.prefill(params, cfg, {"tokens": tok[:, :P]})
    torch.testing.assert_close(got[:, -1], want[:, -1], **TOL)
    full, _ = api.forward(params, cfg, {"tokens": tok[:, :P]})
    torch.testing.assert_close(full, want, **TOL)
    assert cache["mamba"]["ssm"].shape == (7, 2, 4, 8, 64)
    assert cache["shared"]["k"].shape == (3, 2, P, 4, 64)


def test_generate_carries_the_prompt_state_as_the_reference(tiny):
    """The served tokens (the prompt's argmax, then 8 decode argmaxes) are
    the reference's argmax at each position of the prompt and the fed
    tokens, and its logits at each step match the reference's."""
    spec, cfg, params, tok = tiny
    eng = ServeEngine(cfg, params, max_len=P + 16, device="cpu")
    toks, logits, first = eng.generate({"tokens": tok[:, :P]}, n_new=8,
                                       return_logits=True, return_first=True)
    served = torch.cat([torch.as_tensor(first)[:, None],
                        torch.as_tensor(toks)], 1)
    ref = Z.replay(spec, SEED, "model", tok[:, :P], served[:, :-1])
    assert torch.equal(ref.argmax(-1), served)
    torch.testing.assert_close(logits, ref[:, 1:], **TOL)


def test_carry_off_decodes_from_a_zeroed_state(tiny):
    """With carry_prompt_state off, generate is today's engine: the decode
    starts from zeroed recurrent states beside the prompt's KV, the tokens
    of an eager loop from `_load_prefill` without carry; with it on, the
    loop from the carried state. The two differ."""
    import dataclasses
    spec, cfg, params, tok = tiny
    out = {}
    for carry in (False, True):
        c = dataclasses.replace(cfg, carry_prompt_state=carry)
        got = ServeEngine(c, params, max_len=P + 16, device="cpu").generate(
            {"tokens": tok[:, :P]}, n_new=6)
        with torch.no_grad():
            first, pre = api.prefill(params, c, {"tokens": tok[:, :P]})
            cache = api.make_decode_cache(c, 2, P + 16, "cpu")
            _load_prefill(cache, pre, carry=carry)
            if not carry:
                assert not cache["mamba"]["ssm"].any()
            step, nxt, want = make_decode_step(c), first[:, -1].argmax(-1), []
            for i in range(6):
                nxt, _, cache = step(params, {"tokens": nxt[:, None]}, cache,
                                     P + i)
                want.append(nxt)
        np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())
        out[carry] = got
    assert not np.array_equal(out[False], out[True])


@pytest.mark.parametrize("change", ["swap_blocks", "zero_adapter"])
def test_the_wiring_is_exercised(tiny, change):
    """Swapping the two shared blocks, or zeroing the second call's
    adapter, moves the logits."""
    spec, cfg, params, tok = tiny
    if change == "swap_blocks":
        new = dict(params, shared=tree_map(lambda t: t.flip(0),
                                           params["shared"]))
    else:
        b = params["adapter"]["b"].clone()
        b[1] = 0
        new = dict(params, adapter=dict(params["adapter"], b=b))
    a, _ = api.forward(params, cfg, {"tokens": tok[:, :40]})
    b, _ = api.forward(new, cfg, {"tokens": tok[:, :40]})
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("scan", ["ssd", "mlstm"])
def test_ragged_last_chunk_is_the_longer_prompts_prefix(scan):
    """A scan of 300 positions (chunks of 128, 128 and 44) gives the first
    300 outputs of a scan of 384 (three whole chunks)."""
    g = torch.Generator().manual_seed(3)
    B, H, P_, n, L = 2, 3, 16, 8, 384

    def r(*shape):
        return torch.randn(shape, generator=g)
    if scan == "ssd":
        args = (r(B, L, H, P_), r(B, L, n), r(B, L, n),
                torch.nn.functional.softplus(r(B, L, H)), -torch.rand(H) - .1)
        fn = ssm._ssd_chunk_scan
    else:
        args = (r(B, L, H, n), r(B, L, H, n), r(B, L, H, P_), r(B, L, H),
                torch.nn.functional.logsigmoid(r(B, L, H) + 3))
        fn = ssm._mlstm_chunk_scan
    whole, _ = fn(*args)
    part, _ = fn(*(a[:, :300] if a.dim() > 1 else a for a in args))
    torch.testing.assert_close(part, whole[:, :300], atol=1e-5, rtol=1e-5)


def test_reference_matches_transformers_zamba2(tiny):
    """The reference's logits at every position equal HF's
    Zamba2ForCausalLM (torch path, eager attention) on the same weights.
    HF's scan takes one chunk of 512 here: its torch path (transformers
    4.57) sums the chunks' decay over the target chunk's axis (`.sum(dim=2)`
    of (b, h, z, c, p, n) products, where the recurrence sums over the
    source c), so past its first chunk it is not the recurrence (its
    logits left ours by 0.05-0.23 from position 256 on, at chunk 256)."""
    for flag in ("USE_TF", "USE_FLAX"):      # torch alone: a faster import
        os.environ.setdefault(flag, "0")
    tr = pytest.importorskip("transformers")
    spec = tiny[0]
    types = ["hybrid" if l in TINY["hybrid_layer_ids"] else "mamba"
             for l in range(spec.layers)]
    hf_cfg = tr.Zamba2Config(
        vocab_size=spec.vocab, hidden_size=spec.d,
        num_hidden_layers=spec.layers, layers_block_type=types,
        num_attention_heads=spec.heads, num_key_value_heads=spec.kv_heads,
        intermediate_size=spec.ff, hidden_act="gelu",
        mamba_d_state=spec.d_state, mamba_d_conv=spec.conv,
        mamba_expand=spec.expand, mamba_ngroups=spec.groups,
        n_mamba_heads=spec.mamba_heads, num_mem_blocks=spec.blocks,
        adapter_rank=spec.adapter_rank, use_mem_rope=True,
        rope_theta=spec.rope_theta, rms_norm_eps=spec.eps,
        time_step_min=spec.dt_min, time_step_max=spec.dt_max,
        time_step_floor=spec.dt_floor, tie_word_embeddings=True,
        chunk_size=512)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = tr.Zamba2ForCausalLM(hf_cfg).eval()
    m = model.model

    def g(name):
        return Z.make_group(spec, SEED, "model", name, "cpu")

    def put(param, value):
        assert param.shape == value.shape, (param.shape, value.shape)
        param.data.copy_(value)
    io = g("io")
    put(m.embed_tokens.weight, io["embed"])
    put(m.final_layernorm.weight, io["norm_f.scale"])
    calls = {l: i for i, l in enumerate(spec.hybrid)}
    for l, layer in enumerate(m.layers):
        w = g(f"mamba{l}")
        mamba = layer.mamba_decoder if l in calls else layer
        put(mamba.input_layernorm.weight, w["norm.scale"])
        mx = mamba.mamba
        put(mx.in_proj.weight, w["in_proj"].T)
        put(mx.conv1d.weight, w["conv_w"].T[:, None, :])
        put(mx.conv1d.bias, w["conv_b"])
        put(mx.dt_bias, w["dt_bias"])
        put(mx.A_log, w["a_log"])
        put(mx.D, w["d_skip"])
        put(mx.norm.weight, w["gnorm"])
        put(mx.out_proj.weight, w["out_proj"].T)
        if l not in calls:
            continue
        i = calls[l]
        put(layer.linear.weight, g(f"linear{i}")["w"].T)
        blk, sw = layer.shared_transformer, g(f"shared{i % spec.blocks}")
        assert blk.block_id == i % spec.blocks
        put(blk.input_layernorm.weight, sw["norm1.scale"])
        put(blk.pre_ff_layernorm.weight, sw["norm2.scale"])
        for k in ("q", "k", "v", "o"):
            put(getattr(blk.self_attn, f"{k}_proj").weight, sw[f"w{k}"].T)
        ff = blk.feed_forward
        put(ff.gate_up_proj.weight, sw["w_gate_up"].T)
        put(ff.down_proj.weight, sw["w_down"].T)
        ad = g(f"adapter{i}")
        put(ff.gate_up_proj_adapter_list[i][0].weight, ad["a"].T)
        put(ff.gate_up_proj_adapter_list[i][1].weight, ad["b"].T)
    tok = tiny[3][:, :P]
    with torch.no_grad():
        want = model(input_ids=tok, use_cache=False).logits
    torch.testing.assert_close(_ref_logits(spec, tok), want, **TOL)


def test_smoke_counts_a_generates_kernel_calls(tiny, monkeypatch):
    """chip_smoke.py's phase 9h holds a generate's kernel launches on the
    card to `zamba2_launch_shapes`. On the CPU the model reaches the same
    kernel entry points of kernels/ops.py, once a decode step as well
    (the card's graph adds its captured launches at each replay), so spies
    in their place count the calls here by shape."""
    import chip_smoke
    from repro_torch.kernels import ops
    spec, cfg, params, tok = tiny
    seen = {"rmsnorm": {}, "add_rmsnorm": {}, "flash_attention": {},
            "decode_attention": {}}

    def spy(name, real, key):
        def call(*a, **k):
            got = seen[name]
            got[key(*a)] = got.get(key(*a), 0) + 1
            return real(*a, **k)
        return call
    dt = str(cfg.dtype).removeprefix("torch.")
    monkeypatch.setattr(ops, "_rms", spy("rmsnorm", ops._rms,
                                         lambda x, *_: (*x.shape, dt)))
    monkeypatch.setattr(ops, "_add_rms", spy("add_rmsnorm", ops._add_rms,
                                             lambda x, *_: (*x.shape, dt)))
    monkeypatch.setattr(ops, "_flash", spy(
        "flash_attention", ops._flash, lambda q, k, *_: (
            *q.shape[:2], k.shape[1], *q.shape[2:], 0, dt,
            "bhsd" if q.is_contiguous() else "bshd")))
    monkeypatch.setattr(ops, "_decode_attn", spy(
        "decode_attention", ops._decode_attn, lambda q, k, *_: (
            q.shape[0], q.shape[2], k.shape[2], k.shape[1], q.shape[3],
            dt)))
    ServeEngine(cfg, params, max_len=P + 8, device="cpu").generate(
        {"tokens": tok[:, :P]}, n_new=3)
    want = chip_smoke.zamba2_launch_shapes(cfg, 2, P, 3, P + 8)
    assert seen == {k: want[k] for k in seen}
    assert all(not v for k, v in want.items() if k not in seen)
