"""The port's cross-size nested aggregation (repro_torch.core.nested) against
the reference's, on params initialised by the reference and carried over
through numpy.

The index maps and coverage masks are host numpy on both sides and must be
equal bit for bit; so must the copies between sizes, which move values
without arithmetic. The coverage-class sums run in torch and hold at 1e-6;
a whole cross-size round holds at the engines' 1e-4 / 1e-3."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fl as jfl
from repro.core import nested as jnested
from repro.models.cnn import cnn_pool as jcnn_pool, init_cnn as jinit_cnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import nested
from repro_torch.core.aggregation import group_aggregate
from repro_torch.models.cnn import cnn_pool
from repro_torch.utils.pytree import tree_leaves
from test_torch_server import KW, _assert_trees_close, _port_server
from test_torch_server import _one_torch_thread  # noqa: F401 (autouse)

SIZES = ("lite", "small", "medium", "large")


def _pools(dataset="mnist"):
    return jcnn_pool(dataset), cnn_pool(dataset)


def _params(jpool, size, seed):
    """(reference numpy tree, the same as CPU tensors)."""
    ref = jax.device_get(jinit_cnn(jax.random.PRNGKey(seed), jpool[size]))
    return ref, params_from_numpy(ref, "cpu")


def _assert_trees_equal(got, exp):
    """got: tensors (insertion order); exp: the reference's numpy tree,
    compared by path."""
    if isinstance(exp, dict):
        assert set(got) == set(exp)
        for k in exp:
            _assert_trees_equal(got[k], exp[k])
    elif isinstance(exp, (list, tuple)):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            _assert_trees_equal(g, e)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_index_maps_and_coverage_equal_reference_bitwise(dataset):
    """_shared_rows, coverage_mask and covers_all for every ordered pair of
    the pool's sizes, against the reference's numpy."""
    jpool, pool = _pools(dataset)
    for s in SIZES:
        for t in SIZES:
            for a, b in zip(nested._shared_rows(pool[s], pool[t]),
                            jnested._shared_rows(jpool[s], jpool[t])):
                np.testing.assert_array_equal(a, b)
            got = nested.coverage_mask(pool[t], pool[s])
            exp = jnested.coverage_mask(jpool[t], jpool[s])
            for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(exp)):
                assert a.dtype == b.dtype == np.bool_
                np.testing.assert_array_equal(a, b)
            assert (nested.covers_all(pool[t], pool[s])
                    == jnested.covers_all(jpool[t], jpool[s]))
    # a medium model holds all of a small one; a large one does not (its
    # extra pooling stage shrinks the shared flatten grid)
    assert nested.covers_all(pool["small"], pool["medium"])
    assert not nested.covers_all(pool["small"], pool["large"])


@pytest.mark.parametrize("src,dst", [("small", "large"), ("large", "small"),
                                     ("small", "medium"), ("lite", "large"),
                                     ("medium", "small")])
def test_extract_and_embed_equal_reference_bitwise(src, dst):
    """Both directions of the partial map, with and without a base."""
    jpool, pool = _pools()
    jp, tp = _params(jpool, src, 1)
    jb, tb = _params(jpool, dst, 2)
    for fn in ("extract_submodel", "embed_submodel"):
        _assert_trees_equal(
            getattr(nested, fn)(tp, pool[src], pool[dst]),
            getattr(jnested, fn)(jp, jpool[src], jpool[dst]))
        _assert_trees_equal(
            getattr(nested, fn)(tp, pool[src], pool[dst], base=tb),
            getattr(jnested, fn)(jp, jpool[src], jpool[dst], base=jb))
    # the base itself is copied, never written
    _assert_trees_equal(tb, jb)
    z = nested.zeros_params(pool[dst], "cpu")
    _assert_trees_equal(z, jnested.zeros_params(jpool[dst]))


def test_bitwise_invariants_within_the_port():
    """A same-size copy with no base is a passthrough; extract(embed(p))
    gives p back wherever the larger size covers the smaller; a single-size
    pool aggregates through weighted_aggregate, equal to group_aggregate."""
    jpool, pool = _pools()
    _, p = _params(jpool, "small", 3)
    assert nested.extract_submodel(p, pool["small"], pool["small"]) is p
    back = nested.extract_submodel(
        nested.embed_submodel(p, pool["small"], pool["medium"]),
        pool["medium"], pool["small"])
    for a, b in zip(tree_leaves(back), tree_leaves(p)):
        assert torch.equal(a, b)
    g = {"small": _params(jpool, "small", 10)[1]}
    clients = [_params(jpool, "small", 11 + i)[1] for i in range(3)]
    sizes = ["small"] * 3
    ents, accs = [1.0, 0.4, 2.2], [0.3, 0.8, 0.5]
    for stal, mix in ((None, 1.0), ([0, 2, 1], 0.7)):
        a = nested.nested_aggregate(g, {"small": pool["small"]}, clients,
                                    sizes, ents, accs, staleness=stal,
                                    mix=mix)
        b = group_aggregate(g, clients, sizes, ents, accs, staleness=stal,
                            mix=mix)
        for x, y in zip(tree_leaves(a["small"]), tree_leaves(b["small"])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("stal,mix", [(None, 1.0), ([0, 2, 1, 0], 0.6)])
def test_nested_aggregate_matches_reference(stal, mix):
    """A mixed small/medium/large cohort over the three-size pool: every
    size's global against the reference's numpy sums (the large target runs
    the coverage-class path: small and medium do not cover it)."""
    jpool, pool = _pools()
    names = ("small", "medium", "large")
    jg, tg = {}, {}
    for i, s in enumerate(names):
        jg[s], tg[s] = _params(jpool, s, 20 + i)
    sizes = ["small", "large", "medium", "small"]
    carried = [_params(jpool, s, 30 + i) for i, s in enumerate(sizes)]
    ents, accs = [1.2, 0.7, 2.0, 1.5], [0.4, 0.9, 0.6, 0.3]
    exp = jnested.nested_aggregate(
        jg, {s: jpool[s] for s in names}, [c[0] for c in carried], sizes,
        ents, accs, staleness=stal, mix=mix)
    got = nested.nested_aggregate(
        tg, {s: pool[s] for s in names}, [c[1] for c in carried], sizes,
        ents, accs, staleness=stal, mix=mix)
    for s in names:
        _assert_trees_close(got[s], jax.device_get(exp[s]), atol=1e-6,
                            rtol=1e-6)


def test_cross_size_round_matches_reference():
    """One deterministic Algorithm-1 round with aggregation='cross_size'
    from the reference's globals and PPO params: identical host decisions,
    globals of every size at 1e-4 / 1e-3."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=4,
                           engine="batched", aggregation="cross_size")
    srv = _port_server(jsrv, engine="batched", aggregation="cross_size")
    jr = jsrv.run_round(deterministic=True)
    tr = srv.run_round(deterministic=True)
    assert (tr.clients, tr.sizes, tr.intensities) == (
        jr.clients, jr.sizes, jr.intensities)
    assert (tr.local_times, tr.straggling, tr.wall_time) == (
        jr.local_times, jr.straggling, jr.wall_time)
    assert len(set(tr.sizes)) == 2
    for s in jsrv.global_by_size:
        _assert_trees_close(srv.global_by_size[s],
                            jax.device_get(jsrv.global_by_size[s]))
    _assert_trees_close(srv.lite_params, jax.device_get(jsrv.lite_params))
