"""On the card: the port's CUDA kernels against their plain versions, and one
cohort trained through them against the same cohort on the CPU. Every test
here is marked gpu and skips inside its fixture on a machine without CUDA.
The file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import BatchedClientEngine, FLEnvironment, FLSimConfig
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels.ref import kd_loss_ref
from repro_torch.models.cnn import init_cnn
from repro_torch.utils.pytree import tree_leaves, tree_map

TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the tolerances of tests/test_kernels.py
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full float32 on both sides of every comparison: cuDNN convolutions
    # default to TF32, which keeps about three decimal digits
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _inputs(N, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, V)) * 3.0).astype(np.float32)
    y = (rng.standard_normal((N, V)) * 3.0).astype(np.float32)
    return x, y, rng.integers(0, V, N).astype(np.int32)


def _stopgrad_reference(x, y, lab, g):
    """Autograd of the plain version with the Eqs. 33-34 stop-gradients."""
    tx = kd_loss_ref(x, y.detach(), lab)
    ty = kd_loss_ref(x.detach(), y, lab)
    terms = (tx["ce_x"], ty["ce_y"], tx["kl_xy"], ty["kl_yx"])
    loss = sum((gi * t).sum() for gi, t in zip(g, terms))
    return torch.autograd.grad(loss, (x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("N,V,dtype", [(128, 10, "float32"),
                                       (256, 10, "float32"),
                                       (1000, 10, "float32"),
                                       (64, 777, "float32"),
                                       (2048, 32000, "float32"),
                                       (2048, 32000, "bfloat16")])
def test_cuda_kernels_match_plain(cuda, N, V, dtype):
    x, y, lab = _inputs(N, V, seed=5)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda, tdt).requires_grad_(True)
    yt = torch.from_numpy(y).to(cuda, tdt).requires_grad_(True)
    labt = torch.from_numpy(lab).to(cuda)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, N)).astype(np.float32)).to(cuda)
    before = dict(tkd.launches)
    got = tkd.kd_loss(xt, yt, labt)
    loss = sum((gi * got[k]).sum() for gi, k in zip(g, TERMS))
    dx, dy = torch.autograd.grad(loss, (xt, yt))
    torch.cuda.synchronize()
    assert tkd.launches["kd_loss_fwd"] == before["kd_loss_fwd"] + 1
    assert tkd.launches["kd_loss_bwd"] == before["kd_loss_bwd"] + 1
    exp = kd_loss_ref(xt, yt, labt)
    tol = TOL[dtype]
    for k in TERMS:
        torch.testing.assert_close(got[k], exp[k], atol=tol, rtol=tol)
    ex, ey = _stopgrad_reference(xt, yt, labt, g)
    torch.testing.assert_close(dx.float(), ex.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dy.float(), ey.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_non_contiguous(cuda):
    x = torch.zeros((8, 20), device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        tkd.kd_loss_fwd(x, x, torch.zeros(8, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_cuda_cohort_matches_cpu(cuda):
    """A 2-size ragged cohort trained on the card (through the kernels)
    equals the same cohort on the CPU (through the plain versions). GEMMs
    sum in another order on the two devices, hence the tolerance."""
    cfg = FLSimConfig(dataset="mnist", n_train=400, n_test=100,
                      batches_per_epoch=1, default_epochs=2, n_clients=6,
                      k_per_round=4, size_names=("small", "large"))
    gen = torch.Generator().manual_seed(0)
    env0 = FLEnvironment(cfg)
    lite = init_cnn(gen, env0.lite_cfg, "cpu")
    globals_ = {s: init_cnn(gen, c, "cpu") for s, c in env0.pool.items()}
    cohort = ([0, 1, 2, 3], ["small", "small", "large", "large"],
              [1, 3, 2, 1])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        on = lambda t: tree_map(lambda a: a.to(dev), t)
        eng = BatchedClientEngine(FLEnvironment(cfg), device=dev)
        before = tkd.launches["kd_loss_fwd"]
        out[dev.type] = eng.train_cohort(
            *cohort, {s: on(p) for s, p in globals_.items()}, on(lite))
        if dev.type == "cuda":
            assert tkd.launches["kd_loss_fwd"] > before
    for a, b in zip(out["cuda"], out["cpu"]):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-3)
