"""The port's numpy copies (data, partitions, loaders, latency, client
store) against the reference's: results must be bitwise equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import latency as jlat, population as jpop
from repro.data import partition as jpart, pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.core import latency as tlat, population as tpop
from repro_torch.data import partition as tpart, pipeline as tpipe
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("name", ["mnist", "cifar10", "imagenet10"])
def test_image_dataset_bitwise(name):
    a = jsyn.make_image_dataset(name, 64, 16, seed=7)
    b = tsyn.make_image_dataset(name, 64, 16, seed=7)
    assert a.keys() == b.keys()
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_token_dataset_bitwise():
    np.testing.assert_array_equal(jsyn.make_token_dataset(50, 512, seed=3),
                                  tsyn.make_token_dataset(50, 512, seed=3))


@pytest.mark.parametrize("alpha,n_clients", [(0.4, 10), (0.1, 6)])
def test_dirichlet_partition_bitwise(alpha, n_clients):
    labels = np.random.default_rng(0).integers(0, 10, 500).astype(np.int32)
    a = jpart.dirichlet_partition(labels, n_clients, alpha, seed=4)
    b = tpart.dirichlet_partition(labels, n_clients, alpha, seed=4)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(jpart.label_histogram(labels, a[0], 10),
                                  tpart.label_histogram(labels, b[0], 10))


def _loaders(mod, n=3):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((90, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 90).astype(np.int32)
    return [mod.BatchLoader(x[i * 30:(i + 1) * 30], y[i * 30:(i + 1) * 30],
                            8, seed=11 + i) for i in range(n)]


def test_loader_streams_bitwise():
    """sample_many, sample and prefetch_steps consume the loader rng
    exactly as the reference's do."""
    la, lb = _loaders(jpipe), _loaders(tpipe)
    for got, exp in ((lb[0].sample_many(5), la[0].sample_many(5)),
                     (lb[1].sample(), la[1].sample()),
                     (tpipe.prefetch_steps(lb, [0, 2], [3, 1], pad_to=4),
                      jpipe.prefetch_steps(la, [0, 2], [3, 1], pad_to=4)),
                     (lb[2].sample_many(2), la[2].sample_many(2))):
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)


def test_latency_times_bitwise():
    costs, lite = {"small": 2e4, "large": 9e4}, 3e3
    ja, tb = jlat.LatencyModel(costs, lite, seed=2), tlat.LatencyModel(
        costs, lite, seed=2)
    pa = jlat.make_heterogeneous_clients(12, 10.0, list(range(20, 32)), seed=2)
    pb = tlat.make_heterogeneous_clients(12, 10.0, list(range(20, 32)), seed=2)
    sa = jpop.ClientStore.from_profiles(pa, [1.0] * 12,
                                        size_names=("small", "large"))
    sb = tpop.ClientStore.from_profiles(pb, [1.0] * 12,
                                        size_names=("small", "large"))
    clients, sizes, taus = [0, 3, 7, 11], ["small", "large"] * 2, [1, 5, 2, 8]
    for r in range(3):
        np.testing.assert_array_equal(ja.assessment_times(sa, clients, r),
                                      tb.assessment_times(sb, clients, r))
        np.testing.assert_array_equal(
            ja.local_train_times(sa, clients, r, sizes, taus),
            tb.local_train_times(sb, clients, r, sizes, taus))
        assert (ja.assessment_time(pa[3], r)
                == tb.assessment_time(pb[3], r))
    assert ja.relative_time_ratio("large") == tb.relative_time_ratio("large")
