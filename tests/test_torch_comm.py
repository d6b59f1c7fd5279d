"""The port's update codecs (repro_torch.comm) against the reference's, and
their round trip through the port's HAPFL server, on the CPU.

The wire format is host numpy on both sides, so the same delta must encode
to the same bytes: levels, indices, affine maps and dense payloads, and the
error-feedback residuals after it. The identity codec must leave the
server's run bit for bit as it is with no codec."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import make_codec as jmake_codec
from repro.comm.quantize import QuantTensor as JQuantTensor
from repro.core.latency import make_comm_model as jmake_comm_model
from repro.models.cnn import cnn_pool as jcnn_pool, init_cnn as jinit_cnn
from repro_torch import fl as tfl
from repro_torch.comm import DensePayload, QuantTensor, TopKPayload, codec
from repro_torch.comm import make_codec
from repro_torch.convert import params_from_numpy
from repro_torch.core.latency import make_comm_model
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import KW
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

LOSSY = ["int8", "int4", "topk", "topk+int8"]


def _codec_pair(name):
    kw = {} if name.startswith("int") else dict(ratio=0.08, dense_min=256)
    return make_codec(name, **kw), jmake_codec(name, **kw)


def _trees(seed, rounds=1):
    """A reference global (the small mnist CNN, reference init) and
    `rounds` trained-looking client trees beside it, as numpy trees and as
    CPU tensors."""
    ref = jax.device_get(jinit_cnn(jax.random.PRNGKey(seed),
                                   jcnn_pool("mnist")["small"]))
    rng = np.random.default_rng(seed)
    clients = [jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), ref) for _ in range(rounds)]
    conv = lambda t: params_from_numpy(t, "cpu")
    return ref, clients, conv(ref), [conv(c) for c in clients]


def _assert_payload_equal(got, exp):
    assert type(got).__name__ == type(exp).__name__
    if isinstance(got, QuantTensor):
        assert got.q.dtype == exp.q.dtype == np.uint8
        assert got.q.tobytes() == exp.q.tobytes()
        assert (got.lo, got.scale, got.shape, got.bits) == (
            exp.lo, exp.scale, exp.shape, exp.bits)
    elif isinstance(got, TopKPayload):
        assert got.idx.dtype == exp.idx.dtype == np.int32
        assert got.idx.tobytes() == exp.idx.tobytes()
        assert got.shape == exp.shape
        if isinstance(exp.vals, JQuantTensor):
            _assert_payload_equal(got.vals, exp.vals)
        else:
            assert got.vals.tobytes() == exp.vals.tobytes()
    else:
        assert isinstance(got, DensePayload)
        assert got.arr.tobytes() == exp.arr.tobytes()


def test_flatten_enumerates_leaves_in_jax_order():
    """Dict children by sorted key, whatever their insertion order; lists in
    order; None an empty node. The leaf index seeds each leaf's rounding, so
    this order is part of the wire format."""
    tree = {"z": [np.float32(1), {"b": np.float32(2), "a": np.float32(3)}],
            "m": None, "c": (np.float32(4), np.float32(5)),
            "a": np.float32(6)}
    leaves, treedef = codec._flatten(tree)
    assert [float(x) for x in leaves] == [
        float(x) for x in jax.tree_util.tree_leaves(tree)]
    back = codec._unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    _, _, tref, _ = _trees(0)
    order = [x for k in sorted(tref)
             for x in (tref[k] if isinstance(tref[k], list) else [tref[k]])]
    got = codec._flatten(tref)[0]
    assert len(got) == len(order)
    assert all(a is b for a, b in zip(got, order))


@pytest.mark.parametrize("name", LOSSY)
def test_encodings_equal_reference_bytewise(name):
    """One client's delta: every payload, the wire bytes, the residual and
    the decoded tree equal the reference's bit for bit."""
    mine, ref = _codec_pair(name)
    jr, (jp,), tr, (tp,) = _trees(1)
    kw = dict(seed=7, client=3, round_idx=2, tag="local")
    enc, state = mine.encode(tp, tr, None, **kw)
    jenc, jstate = ref.encode(jp, jr, None, **kw)
    assert enc.wire_bytes == jenc.wire_bytes
    assert len(enc.payloads) == len(jenc.payloads)
    for g, e in zip(enc.payloads, jenc.payloads):
        _assert_payload_equal(g, e)
    for g, e in zip(state, jstate):
        assert g.tobytes() == e.tobytes()
    if name.startswith("topk"):
        assert any(isinstance(p, DensePayload) for p in enc.payloads)
    dec = mine.decode(enc, tr)
    jdec = ref.decode(jenc, jr)
    for g, e in zip(codec._flatten(dec)[0], jax.tree_util.tree_leaves(jdec)):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(e).tobytes()


@pytest.mark.parametrize("name", ["topk+int8", "int4"])
def test_error_feedback_residuals_match_reference_over_three_rounds(name):
    """The residual each round carries into the next, threaded through three
    encodes of a client's successive trees, equals the reference's."""
    mine, ref = _codec_pair(name)
    jr, jps, tr, tps = _trees(2, rounds=3)
    state = jstate = None
    for r, (jp, tp) in enumerate(zip(jps, tps)):
        kw = dict(seed=0, client=5, round_idx=r, tag="lite")
        enc, state = mine.encode(tp, tr, state, **kw)
        jenc, jstate = ref.encode(jp, jr, jstate, **kw)
        assert enc.wire_bytes == jenc.wire_bytes
        for g, e in zip(state, jstate):
            assert g.tobytes() == e.tobytes()
    assert any(np.any(s != 0) for s in state)


def _two_rounds(codec):
    """Two rounds of a port server on the CPU; also returns the first
    round's plan and the params its engine trained, before any codec."""
    srv = tfl.HAPFLServer(tfl.FLEnvironment(tfl.FLSimConfig(**KW)), seed=3,
                          device="cpu", engine="batched", codec=codec)
    trained, train = [], srv.batched_engine.train_cohort
    srv.batched_engine.train_cohort = \
        lambda *a, **k: trained.extend(train(*a, **k)) or trained
    plan = srv.plan_wave()
    srv.train_wave(plan)
    srv.batched_engine.train_cohort = train
    srv.apply_updates(srv.wave_updates(plan))
    srv.record_wave(plan, *srv.feedback_wave(plan))
    srv.run_round()
    return srv, plan, trained


def test_identity_codec_is_bitwise_no_codec_on_the_server():
    """codec='identity' passes the trained tensors through untouched (no
    host copy, no residual): the same seed gives the same records and
    globals bit for bit as no codec."""
    a, plan_a, _ = _two_rounds(None)
    b, plan_b, trained = _two_rounds("identity")
    assert plan_a.wire_bytes == [] and len(plan_b.wire_bytes) == 4
    assert all(x is y for p, q in zip(plan_b.client_params, trained)
               for x, y in zip(tree_leaves(p), tree_leaves(q)))
    assert b._ef == {}
    for x, y in zip(a.history, b.history):
        assert (x.clients, x.sizes, x.intensities, x.acc_lite,
                x.acc_by_size, x.client_acc) == (
            y.clients, y.sizes, y.intensities, y.acc_lite, y.acc_by_size,
            y.client_acc)
    for p, q in zip(tree_leaves([a.lite_params, a.global_by_size]),
                    tree_leaves([b.lite_params, b.global_by_size])):
        assert torch.equal(p, q)


def test_lossy_codec_works_under_cross_size():
    """topk+int8 under cross-size aggregation: per-client wire bytes under
    a quarter of dense, residuals per (client, kind, size), every global
    finite and every size's global moved."""
    srv = tfl.HAPFLServer(tfl.FLEnvironment(tfl.FLSimConfig(**KW)), seed=1,
                          device="cpu", aggregation="cross_size",
                          codec=make_codec("topk+int8", ratio=0.08))
    env = srv.env
    before = {s: [t.clone() for t in tree_leaves(p)]
              for s, p in srv.global_by_size.items()}
    for _ in range(2):
        plan = srv.plan_wave()
        srv.train_wave(plan)
        for i, (c, s) in enumerate(zip(plan.clients, plan.sizes)):
            dense = 4.0 * (env.pool[s].num_params()
                           + env.lite_cfg.num_params())
            assert plan.wire_bytes[i] < dense / 4
            assert (c, "local", s) in srv._ef and (c, "lite", "") in srv._ef
        srv.apply_updates(srv.wave_updates(plan))
        srv.record_wave(plan, *srv.feedback_wave(plan))
    for s, p in srv.global_by_size.items():
        after = tree_leaves(p)
        assert all(bool(torch.isfinite(t).all()) for t in after)
        assert any(not torch.equal(x, y) for x, y in zip(before[s], after))


@pytest.mark.parametrize("name", ["topk+int8", "int4", "identity"])
def test_make_comm_model_accepts_codec_names(name):
    """A codec name prices the same upload and download times as the
    reference's CommModel."""
    pool = jcnn_pool("mnist")
    args = ({s: float(pool[s].num_params()) for s in ("small", "large")},
            float(pool["lite"].num_params()), 6)
    kw = dict(mean_mbps=0.5, codec=name,
              model_tensors={s: pool[s].num_tensors()
                             for s in ("small", "large")},
              lite_tensors=pool["lite"].num_tensors())
    mine, ref = make_comm_model(*args, **kw), jmake_comm_model(*args, **kw)
    assert mine.codec.name == ref.codec.name
    for c in range(6):
        for s in ("small", "large"):
            assert mine.upload_time(c, s) == ref.upload_time(c, s)
            assert mine.download_time(c, s) == ref.download_time(c, s)
