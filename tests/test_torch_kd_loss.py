"""kd_loss in the port: the plain version against the reference's Pallas
kernel (interpret mode), the autograd.Function's gradients against autograd
of the plain version, and distill.mutual_losses against the reference's
loss, metrics and per-leaf grads. The CUDA kernels are held against the
plain version on a card by tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distill as jdistill
from repro.kernels.kd_loss import kd_loss as pallas_kd_loss
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import distill as tdistill
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels.ref import kd_loss_ref
from repro_torch.models import cnn as tcnn
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the tolerances of tests/test_kernels.py
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(N, V, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, V)) * scale).astype(np.float32)
    y = (rng.standard_normal((N, V)) * scale).astype(np.float32)
    return x, y, rng.integers(0, V, N).astype(np.int32)


# V 777 and V 4099: rows whose length is no multiple of 16 bytes in either
# dtype, which the CUDA kernels read with scalar loads
@pytest.mark.parametrize("N,V,block_n", [(64, 512, 32), (128, 1000, 32),
                                         (32, 2048, 32), (64, 777, 64),
                                         (48, 777, 16), (32, 4099, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_kernel(N, V, block_n, dtype):
    x, y, lab = _inputs(N, V)
    jx, jy = jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype)
    exp = pallas_kd_loss(jx, jy, jnp.asarray(lab), block_n=block_n,
                         block_v=256, interpret=True)
    tdt = getattr(torch, dtype)
    got = kd_loss_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
                      torch.from_numpy(lab))
    for k in TERMS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_on_an_unaligned_row_slice(dtype):
    """The plain versions on rows 3:67 of a (70, 4099) tensor (a view whose
    base lies off 16 bytes, as chip_smoke.py and the card tests give the
    kernels) equal the same rows of the whole call, forward and backward."""
    x, y, lab = (torch.from_numpy(a) for a in _inputs(70, 4099, seed=5))
    tdt = getattr(torch, dtype)
    x, y = x.to(tdt), y.to(tdt)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 70)).astype(np.float32))
    terms, stats = tkd.kd_loss_fwd(x, y, lab)
    dx, dy = tkd.kd_loss_bwd(x, y, lab, stats, g)
    xs, ys, ls = x[3:67], y[3:67], lab[3:67]
    assert xs.data_ptr() % 16 != 0
    t_s, s_s = tkd.kd_loss_fwd(xs, ys, ls)
    dx_s, dy_s = tkd.kd_loss_bwd(xs, ys, ls, s_s, g[:, 3:67].contiguous())
    for whole, part in ((terms[:, 3:67], t_s), (stats[:, 3:67], s_s),
                        (dx[3:67], dx_s), (dy[3:67], dy_s)):
        torch.testing.assert_close(part, whole, atol=1e-6, rtol=1e-6)


def _stopgrad_reference(x, y, lab, g):
    """Autograd of the plain version with the Eqs. 33-34 stop-gradients:
    (ce_x, kl_xy) see y detached, (ce_y, kl_yx) see x detached."""
    tx = kd_loss_ref(x, y.detach(), lab)
    ty = kd_loss_ref(x.detach(), y, lab)
    terms = (tx["ce_x"], ty["ce_y"], tx["kl_xy"], ty["kl_yx"])
    loss = sum((gi * t).sum() for gi, t in zip(g, terms))
    return torch.autograd.grad(loss, (x, y))


@pytest.mark.parametrize("N,V", [(256, 10), (33, 777)])
def test_function_grads_match_plain_autograd(N, V):
    """The CPU path of KDLoss (the kernels' plain versions) gives the terms
    of kd_loss_ref and the gradients of its stop-gradient autograd."""
    x, y, lab = _inputs(N, V, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, N)).astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    labt = torch.from_numpy(lab).long()
    got = tkd.kd_loss(xt, yt, labt)
    exp = kd_loss_ref(xt, yt, labt)
    for k in TERMS:
        torch.testing.assert_close(got[k], exp[k], atol=1e-5, rtol=1e-5)
    loss = sum((gi * got[k]).sum() for gi, k in zip(g, TERMS))
    dx, dy = torch.autograd.grad(loss, (xt, yt))
    ex, ey = _stopgrad_reference(xt, yt, labt, g)
    torch.testing.assert_close(dx, ex, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dy, ey, atol=1e-5, rtol=1e-5)


def test_cpu_calls_do_not_count_as_launches():
    tkd.reset_launches()
    x, y, lab = _inputs(8, 10)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tkd.kd_loss(xt, torch.from_numpy(y), torch.from_numpy(lab))
    loss["ce_x"].sum().backward()
    assert tkd.launches == {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                            "kd_loss_grad": 0}


@pytest.mark.parametrize("bad", ["float64", "shape", "labels", "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    x, y, lab = (torch.from_numpy(a) for a in _inputs(4, 10))
    if bad == "float64":
        x, y = x.double(), y.double()
    elif bad == "shape":
        y = y[:, :9]
    elif bad == "labels":
        lab = lab.float()
    else:
        x, y, lab = x[:0], y[:0], lab[:0]
    with pytest.raises((TypeError, ValueError)):
        tkd.kd_loss_fwd(x, y, lab)


def test_mutual_losses_match_reference_value_and_grad():
    """Loss, metrics and the grads of every param leaf of both models,
    through apply_cnn, against jax.value_and_grad of the reference."""
    pool = jcnn.cnn_pool("mnist")
    cl, cs = pool["lite"], pool["small"]
    jparams = {"local": jcnn.init_cnn(jax.random.PRNGKey(0), cs),
               "lite": jcnn.init_cnn(jax.random.PRNGKey(1), cl)}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8,) + cs.in_shape).astype(np.float32)
    lab = rng.integers(0, 10, 8).astype(np.int32)

    def jloss(p):
        return jdistill.mutual_losses(jcnn.apply_cnn(p["local"], cs, x),
                                      jcnn.apply_cnn(p["lite"], cl, x), lab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)

    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    xt, labt = torch.from_numpy(x), torch.from_numpy(lab)
    tl, tm = tdistill.mutual_losses(
        tcnn.apply_cnn(tparams["local"], cs, xt),
        tcnn.apply_cnn(tparams["lite"], cl, xt), labt)
    tg = tree_unflatten(tparams, torch.autograd.grad(tl, leaves))
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    jg = params_from_numpy(jax.device_get(jg), "cpu")
    for m in ("local", "lite"):
        for a, b in zip(tree_leaves(tg[m]), tree_leaves(jg[m])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_client_axis_sums_per_client_means():
    """(C, B, V) logits: the loss is the sum of each client's own (B, V)
    loss, so one backward gives each client the gradient it would get
    alone."""
    x, y, lab = _inputs(12, 10, seed=4)
    xs = torch.from_numpy(x).view(3, 4, 10).requires_grad_(True)
    ys = torch.from_numpy(y).view(3, 4, 10)
    labs = torch.from_numpy(lab).view(3, 4)
    total, metrics = tdistill.mutual_losses(xs, ys, labs)
    (gx,) = torch.autograd.grad(total, xs)
    for c in range(3):
        xc = xs[c].detach().clone().requires_grad_(True)
        lc, mc = tdistill.mutual_losses(xc, ys[c], labs[c])
        (gc,) = torch.autograd.grad(lc, xc)
        torch.testing.assert_close(gx[c], gc, atol=1e-6, rtol=1e-6)
        for k in mc:
            torch.testing.assert_close(metrics[k][c], mc[k])
