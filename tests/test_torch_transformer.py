"""The port's dense-decoder serving path against the reference: configs,
layers, the model's forward / prefill / decode, ServeEngine.generate and a
sliding-window ring-buffer cache, on the CPU (rmsnorm and flash attention
through their wrappers' plain path). Params are made by the reference and
carried over through numpy (repro_torch.convert). The configs are the fp32
smoke cut of llama3.2-3b with 2 KV heads of 4, so GQA is exercised.

Tolerances: 1e-5 for layers, 1e-4 for model logits; generated tokens are
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.utils.pytree import tree_leaves


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


# the reference's entry points, compiled once per config
_jforward = jax.jit(japi.forward, static_argnums=1)
_jprefill = jax.jit(japi.prefill, static_argnums=1)
_jdecode = jax.jit(japi.decode_step, static_argnums=1)


def _cfgs(**overrides):
    """The reference's and the port's llama3.2-3b smoke config with GQA."""
    kw = dict(n_kv_heads=2, **overrides)
    return (dataclasses.replace(jget_config("llama3.2-3b").smoke(), **kw),
            dataclasses.replace(tget_config("llama3.2-3b").smoke(), **kw))


def _params(jcfg, seed=0):
    jp = japi.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def gqa_model():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """Field by field, and every derived config and count, the same as the
    reference's; only llama3.2-3b's source differs (it names the 3B
    checkpoint whose numbers these are)."""
    j, t = jget_config(arch), tget_config(arch)
    for jc, tc in [(j, t), (j.smoke(), t.smoke()), (j.lite(), t.lite()),
                   *zip(j.size_variants().values(),
                        t.size_variants().values())]:
        jd, td = jc.asdict(), tc.asdict()
        if arch == "llama3.2-3b":
            assert td.pop("source") == "hf:meta-llama/Llama-3.2-3B"
            jd.pop("source")
        assert td == jd
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
    assert t.dtype == torch.bfloat16 and t.smoke().dtype == torch.float32


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    x = _normal((2, 12, 3, 64), 1)
    pos = np.random.default_rng(2).integers(0, 600, (2, 12)).astype(np.int32)
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, exp, 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp_matches_reference(act):
    x = _normal((2, 7, 64), 3)
    jp = jlayers.init_mlp(jax.random.PRNGKey(4), 64, 128, act, jnp.float32)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    _close(tlayers.apply_mlp(tp, torch.from_numpy(x), act),
           jlayers.apply_mlp(jp, jnp.asarray(x), act), 1e-5)


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
def test_params_tree_matches_reference_leaf_for_leaf(gqa_model):
    jcfg, tcfg, jp, tp = gqa_model
    own = tapi.init_model(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(own)) == len(ref)
    for path, leaf in ref:
        node = own
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32


def test_forward_matches_reference(gqa_model):
    jcfg, tcfg, jp, tp = gqa_model
    tok = _tokens(2, 24, jcfg.vocab_size, 5)
    exp, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, aux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and aux == {}
    _close(got, exp, 1e-4)


def test_prefill_and_decode_steps_match_reference(gqa_model):
    """Prefill logits and cache, then 4 decode steps fed the same tokens;
    the port's cache is updated in place."""
    jcfg, tcfg, jp, tp = gqa_model
    B, S, L = 2, 10, 16
    tok = _tokens(B, S, jcfg.vocab_size, 6)
    jl, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tok)})
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    assert tl.shape == (B, 1, jcfg.vocab_size)
    _close(tl, jl, 1e-4)
    for key in ("k", "v"):
        _close(tc["blocks"][key], jc["blocks"][key], 1e-4)
    jcache = jax.tree_util.tree_map(
        lambda big, small: jax.lax.dynamic_update_slice(big, small, (0,) * 5),
        japi.make_decode_cache(jcfg, B, L), jc)
    tcache = tapi.make_decode_cache(tcfg, B, L, device="cpu")
    for key in ("k", "v"):
        tcache["blocks"][key][:, :, :S] = tc["blocks"][key]
    for i in range(4):
        step = _tokens(B, 1, jcfg.vocab_size, 7 + i)
        jl, jcache = _jdecode(jp, jcfg, {"tokens": jnp.asarray(step)},
                              jcache, S + i)
        kept = tcache["blocks"]["k"]
        tl, tcache = tapi.decode_step(tp, tcfg,
                                      {"tokens": torch.from_numpy(step)},
                                      tcache, S + i)
        assert tcache["blocks"]["k"] is kept
        _close(tl, jl, 1e-4)
        _close(tcache["blocks"]["k"], jcache["blocks"]["k"], 1e-4)


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmo-1b", "granite-20b"])
def test_forward_matches_reference_for_each_norm(arch):
    """The residual adds folded into the norms: rmsnorm through
    add_rmsnorm (granite-3-8b, untied head), and the unfused add before
    nonparam_ln (olmo) and layernorm (granite-20b, one KV head)."""
    jcfg = jget_config(arch).smoke()
    tcfg = tget_config(arch).smoke()
    jp, tp = _params(jcfg, seed=3)
    tok = _tokens(2, 16, jcfg.vocab_size, 12)
    exp, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, _ = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    _close(got, exp, 1e-4)


def test_decode_step_with_a_tensor_index_matches_reference_across_the_wrap():
    """The decode step at a 0-d int64 tensor position (what the CUDA graph
    replays) gives the reference's logits and cache at positions before
    and after an 8-slot sliding-window ring buffer wraps."""
    jcfg, tcfg = _cfgs(sliding_window=8)
    jp, tp = _params(jcfg, seed=4)
    B, S = 2, 6
    tok = _tokens(B, S, jcfg.vocab_size, 13)
    _, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tok)})
    _, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    jcache = jax.tree_util.tree_map(
        lambda big, small: jax.lax.dynamic_update_slice(big, small, (0,) * 5),
        japi.make_decode_cache(jcfg, B, 32), jc)
    tcache = tapi.make_decode_cache(tcfg, B, 32, device="cpu")
    assert tcache["blocks"]["k"].shape[2] == 8
    for key in ("k", "v"):
        tcache["blocks"][key][:, :, :S] = tc["blocks"][key]
    index = torch.zeros((), dtype=torch.int64)
    for i in range(7):          # positions 6..12: slots 6, 7, 0, 1, ...
        step = _tokens(B, 1, jcfg.vocab_size, 20 + i)
        jl, jcache = _jdecode(jp, jcfg, {"tokens": jnp.asarray(step)},
                              jcache, S + i)
        index.fill_(S + i)
        tl, tcache = tapi.decode_step(tp, tcfg,
                                      {"tokens": torch.from_numpy(step)},
                                      tcache, index)
        _close(tl, jl, 1e-4)
        for key in ("k", "v"):
            _close(tcache["blocks"][key], jcache["blocks"][key], 1e-4)


@pytest.mark.parametrize("window", [0, 8])
def test_generate_logits_are_the_decode_step_loop(window):
    """generate(return_logits=True) runs the engine's static decode step
    (the code a CUDA graph captures on the card); on the CPU its tokens and
    logits equal a plain loop of make_decode_step, bit for bit."""
    from repro_torch.serve import make_decode_step
    jcfg, tcfg = _cfgs(sliding_window=window)
    _, tp = _params(jcfg, seed=5)
    tok = _tokens(2, 6, jcfg.vocab_size, 14)
    eng = TServeEngine(tcfg, tp, max_len=32, device="cpu")
    got, logits = eng.generate({"tokens": tok}, n_new=12, return_logits=True)
    assert logits.shape == (2, 12, tcfg.vocab_size)
    step = make_decode_step(tcfg)
    with torch.no_grad():
        first, pre = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)})
        cache = tapi.make_decode_cache(tcfg, 2, 32, device="cpu")
        for key in ("k", "v"):
            cache["blocks"][key][:, :, :6] = pre["blocks"][key]
        nxt = first[:, -1].argmax(-1)
        for i in range(12):
            nxt, lg, cache = step(tp, {"tokens": nxt[:, None]}, cache,
                                  torch.tensor(6 + i))
            assert torch.equal(lg[:, -1], logits[:, i])
            np.testing.assert_array_equal(nxt.numpy(), got[:, i])


@pytest.mark.parametrize("window,prompt,n_new,max_len",
                         [(0, 12, 8, 32), (8, 6, 24, 64)])
def test_generate_matches_reference(window, prompt, n_new, max_len):
    """Greedy tokens from ServeEngine.generate are identical: a full cache,
    and a sliding-window ring buffer of 8 slots that 24 decode steps wrap
    around three times."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _params(jcfg, seed=1)
    tok = _tokens(3, prompt, jcfg.vocab_size, 8)
    exp = JServeEngine(jcfg, jp, max_len=max_len).generate(
        {"tokens": jnp.asarray(tok)}, n_new=n_new)
    got = TServeEngine(tcfg, tp, max_len=max_len, device="cpu").generate(
        {"tokens": tok}, n_new=n_new)
    assert got.shape == (3, n_new)
    np.testing.assert_array_equal(got, np.asarray(exp))


def test_generate_rejects_a_prompt_longer_than_the_cache(gqa_model):
    jcfg, tcfg, jp, tp = gqa_model
    eng = TServeEngine(tcfg, tp, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="longer"):
        eng.generate({"tokens": _tokens(1, 9, tcfg.vocab_size, 9)}, n_new=1)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_ssm_params_tree_matches_reference(arch):
    """init_model builds the hybrid's and the xLSTM's trees leaf for leaf as
    the reference's, shapes and dtypes (bf16 projections beside fp32 gates,
    recurrent weights and biases in a bf16 model; all fp32 in an fp32
    one): zamba2's {"mamba": (n_seg, seg, ...), "shared", "mamba_tail"},
    xlstm's {"mlstm": (g, m_per, ...), "slstm": (g, ...), "mlstm_tail"}.
    The reference's params drop in through params_from_numpy. Both at 5
    layers, a layout with a tail: slstm_every 2, shared_attn_every 2."""
    layout = ({"slstm_every": 2} if arch == "xlstm-1.3b"
              else {"shared_attn_every": 2})
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jcfg = dataclasses.replace(jget_config(arch).smoke(), n_layers=5,
                                   dtype=jdt, **layout)
        tcfg = dataclasses.replace(tget_config(arch).smoke(), n_layers=5,
                                   dtype=tdt, **layout)
        own = tapi.init_model(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
        jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
        ref = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(tree_leaves(own)) == len(ref)
        for path, leaf in ref:
            node = own
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).removeprefix("torch.") == str(
                leaf.dtype), path
        assert set(own) == set(jp) == (
            {"io", "mlstm", "slstm", "mlstm_tail"} if arch == "xlstm-1.3b"
            else {"io", "mamba", "shared", "mamba_tail"})
        converted = params_from_numpy(jax.device_get(jp), device="cpu")
        assert len(tree_leaves(converted)) == len(ref)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_vlm_and_audio_params_tree_matches_reference(arch):
    """init_model builds the VLM's and the audio model's trees leaf for leaf
    as the reference's (musicgen: an (nq, V, d) embedding and an (nq, d, V)
    head), so the reference's params drop in through params_from_numpy."""
    jcfg, tcfg = jget_config(arch).smoke(), tget_config(arch).smoke()
    own = tapi.init_model(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(own)) == len(ref)
    for path, leaf in ref:
        node = own
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
    if jcfg.n_codebooks:
        nq, V, d = jcfg.n_codebooks, jcfg.vocab_size, jcfg.d_model
        assert tuple(own["io"]["embed"].shape) == (nq, V, d)
        assert tuple(own["io"]["head"].shape) == (nq, d, V)
    converted = params_from_numpy(jax.device_get(jp), device="cpu")
    assert len(tree_leaves(converted)) == len(ref)


def test_bf16_params_cross_numpy_bit_for_bit():
    """bf16 leaves from jax.device_get arrive as torch.bfloat16 bit for bit,
    and leave as float32, which holds them exactly."""
    jp = {"w": jnp.asarray(_normal((5, 7), 10)).astype(jnp.bfloat16),
          "n": [jnp.arange(3, dtype=jnp.int32)]}
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["w"].view(torch.int16).numpy(),
        np.asarray(jax.device_get(jp["w"])).view(np.int16))
    back = params_to_numpy(tp)
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], np.asarray(jp["w"], np.float32))
    np.testing.assert_array_equal(back["n"][0], np.arange(3))
