"""The port's CNN pool against repro.models.cnn on JAX-initialized params:
logits of apply_cnn and of apply_cnn_fast (client axis written out)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import cnn as tcnn
from repro_torch.utils.pytree import tree_map

# float32 convolutions and GEMMs sum in another order in XLA and PyTorch
ATOL = 1e-5


def _pool_cases():
    return [(d, s) for d in ("mnist", "cifar10", "imagenet10")
            for s in ("lite", "small", "medium", "large")]


@pytest.mark.parametrize("dataset,size", _pool_cases())
def test_apply_cnn_matches_reference(dataset, size):
    cfg = jcnn.cnn_pool(dataset)[size]
    assert tcnn.cnn_pool(dataset)[size] == tcnn.CNNConfig(
        cfg.name, cfg.in_shape, cfg.channels, cfg.hidden, cfg.n_classes)
    jp = jax.jit(jcnn.init_cnn, static_argnums=1)(jax.random.PRNGKey(3), cfg)
    x = np.random.default_rng(0).standard_normal(
        (3,) + cfg.in_shape).astype(np.float32)
    exp = np.asarray(jax.jit(jcnn.apply_cnn, static_argnums=1)(jp, cfg, x))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    got = tcnn.apply_cnn(tp, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, exp, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "imagenet10"])
def test_apply_cnn_fast_client_axis(dataset):
    """Two clients with different params in one stacked call: each client's
    logits equal the reference's apply_cnn_fast on its own params."""
    cfg = jcnn.cnn_pool(dataset)["large"]
    init = jax.jit(jcnn.init_cnn, static_argnums=1)
    jps = [init(jax.random.PRNGKey(i), cfg) for i in (5, 6)]
    x = np.random.default_rng(1).standard_normal(
        (2, 4) + cfg.in_shape).astype(np.float32)
    tps = [params_from_numpy(jax.device_get(p), "cpu") for p in jps]
    stacked = tree_map(lambda a, b: torch.stack([a, b]), *tps)
    got = tcnn.apply_cnn_fast(stacked, cfg, torch.from_numpy(x)).numpy()
    fast = jax.jit(jcnn.apply_cnn_fast, static_argnums=1)
    for c in range(2):
        exp = np.asarray(fast(jps[c], cfg, x[c]))
        np.testing.assert_allclose(got[c], exp, atol=ATOL, rtol=1e-5)


def test_init_cnn_layout_and_round_trip():
    cfg = tcnn.cnn_pool("cifar10")["large"]
    tp = tcnn.init_cnn(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), cfg))
    shapes = lambda t: tree_map(lambda a: tuple(a.shape), t)
    assert shapes(params_to_numpy(tp)) == shapes(jp)
    n = sum(a.numel() for a in tp["conv"] + tp["conv_b"]) + sum(
        tp[k].numel() for k in ("fc1", "fc1_b", "fc2", "fc2_b"))
    assert n == cfg.num_params()
    back = params_from_numpy(params_to_numpy(tp), "cpu")
    for a, b in zip(back["conv"], tp["conv"]):
        assert torch.equal(a, b)
