"""The port's fused kernels on the CPU (their plain versions), against the
reference: add_rmsnorm (the residual add folded into the norm after it)
and kd_loss_grad (the mutual-KD step's loss means and logit gradients in
one launch), and the training step built on kd_loss_grad against the step
that differentiates `mutual_losses` by autograd. The CUDA kernels are held
against these plain versions on a card by tests/test_torch_gpu.py.

Tolerances: add_rmsnorm's plain version equals add-then-rmsnorm bit for
bit; against the reference's Pallas rmsnorm (interpret mode) 1e-5 in fp32.
kd_loss_grad against jax.value_and_grad of `repro.core.distill`
.mutual_losses 1e-5 in fp32, accuracies exact; three training steps 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distill as jdistill
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import distill as tdistill
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels.ref import (add_rmsnorm_ref, kd_loss_grad_ref,
                                     rmsnorm_ref)
from repro_torch.models import cnn as tcnn
from repro_torch.models.layers import apply_add_norm, apply_norm
from repro_torch.optim import sgd
from repro_torch.utils.pytree import (tree_add, tree_leaves, tree_map,
                                      tree_unflatten)

LAMBDAS = (0.4, 0.6, 0.5, 0.5)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------- #
# add_rmsnorm
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(64, 256), (4, 3072), (7, 777)])
def test_add_rmsnorm_is_add_then_rmsnorm_bitwise(N, d, dtype):
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_normal((N, d), 1)).to(tdt)
    delta = torch.from_numpy(_normal((N, d), 2)).to(tdt)
    sc = torch.from_numpy(1 + _normal((d,), 3, 0.1)).to(tdt)
    s, y = add_rmsnorm_ref(x, delta, sc)
    assert s.dtype == y.dtype == tdt
    assert torch.equal(s, x + delta)
    assert torch.equal(y, rmsnorm_ref(x + delta, sc))
    ws, wy = trms.add_rmsnorm(x, delta, sc)      # the wrapper's CPU path
    assert torch.equal(ws, s) and torch.equal(wy, y)


@pytest.mark.parametrize("N,d", [(64, 256), (32, 768)])
def test_add_rmsnorm_matches_reference_rmsnorm_of_the_sum(N, d):
    """The s it returns, normed by the reference's Pallas kernel in
    interpret mode, gives its y."""
    x = torch.from_numpy(_normal((N, d), 4, 2.0))
    delta = torch.from_numpy(_normal((N, d), 5))
    sc = torch.from_numpy(1 + _normal((d,), 6, 0.1))
    s, y = add_rmsnorm_ref(x, delta, sc)
    exp = pallas_rmsnorm(jnp.asarray(s.numpy()), jnp.asarray(sc.numpy()),
                         block_n=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_add_norm_is_the_add_then_the_norm(kind):
    d = 48
    x = torch.from_numpy(_normal((2, 5, d), 7))
    delta = torch.from_numpy(_normal((2, 5, d), 8))
    params = {"rmsnorm": {"scale": torch.from_numpy(1 + _normal((d,), 9))},
              "layernorm": {"scale": torch.from_numpy(1 + _normal((d,), 9)),
                            "bias": torch.from_numpy(_normal((d,), 10))},
              "nonparam_ln": {}}[kind]
    s, y = apply_add_norm(params, x, delta, kind)
    assert s.shape == y.shape == x.shape
    assert torch.equal(s, x + delta)
    assert torch.equal(y, apply_norm(params, x + delta, kind))


def test_add_rmsnorm_wrapper_rejects_bad_inputs():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):                 # delta's shape differs
        trms.add_rmsnorm(x, torch.zeros((4, 9)), torch.ones(8))
    with pytest.raises(ValueError):
        trms.add_rmsnorm(x, x, torch.ones(7))
    with pytest.raises(TypeError):
        trms.add_rmsnorm(x, x.bfloat16(), torch.ones(8))
    with pytest.raises(TypeError):
        trms.add_rmsnorm(x.double(), x.double(), torch.ones(8).double())


# ---------------------------------------------------------------------- #
# kd_loss_grad
# ---------------------------------------------------------------------- #
def _logits(C, B, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, B, V)) * 3.0).astype(np.float32)
    y = (rng.standard_normal((C, B, V)) * 3.0).astype(np.float32)
    return x, y, rng.integers(0, V, (C, B)).astype(np.int32)


def _reference_step_terms(x, y, lab):
    """jax.value_and_grad of the reference's mutual_losses, vmapped over
    the client axis and summed: (loss, metrics (C,) each, kl_yx (C,),
    d loss / d x, d loss / d y)."""
    def total(a, b):
        losses, metrics = jax.vmap(jdistill.mutual_losses)(a, b, lab)
        return losses.sum(), metrics
    (loss, metrics), (gx, gy) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    kl_yx = jax.vmap(jdistill._kl)(jnp.asarray(y), jnp.asarray(x))
    return loss, metrics, kl_yx, gx, gy


@pytest.mark.parametrize("C,B,V", [(8, 32, 10), (4, 32, 10), (2, 16, 777)])
def test_kd_loss_grad_ref_matches_reference_value_and_grad(C, B, V):
    x, y, lab = _logits(C, B, V, seed=C + V)
    loss, jm, kl_yx, gx, gy = _reference_step_terms(x, y, lab)
    dx, dy, means = kd_loss_grad_ref(torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(lab), LAMBDAS)
    assert means.shape == (6, C) and means.dtype == torch.float32
    got = means.numpy()
    for row, exp in ((0, jm["ce_local"]), (1, jm["ce_lite"]),
                     (2, jm["kl_local_lite"]), (3, kl_yx)):
        np.testing.assert_allclose(got[row], np.asarray(exp), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(got[4], np.asarray(jm["acc_local"]))
    np.testing.assert_array_equal(got[5], np.asarray(jm["acc_lite"]))
    l1, l2, l3, l4 = LAMBDAS
    total = (l1 * got[0] + l2 * got[2] + l3 * got[1] + l4 * got[3]).sum()
    np.testing.assert_allclose(total, float(loss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(dy.numpy(), np.asarray(gy), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kd_loss_grad_wrapper_takes_one_client_and_strided_labels(dtype):
    """(B, V) logits are one client; labels may be a (C, B) view with a
    client stride (the batched engine's ys[:, t]); bf16 gradients come back
    in bf16."""
    tdt = getattr(torch, dtype)
    x, y, lab = _logits(3, 8, 12, seed=11)
    xt, yt = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    steps = torch.from_numpy(np.stack([lab, lab[::-1].copy()], axis=1))
    dx, dy, means = tkd.kd_loss_grad(xt, yt, steps[:, 0], LAMBDAS)
    ex, ey, em = kd_loss_grad_ref(xt, yt, torch.from_numpy(lab), LAMBDAS)
    assert dx.dtype == dy.dtype == tdt
    assert torch.equal(dx, ex) and torch.equal(dy, ey)
    assert torch.equal(means, em)
    one = tkd.kd_loss_grad(xt[1], yt[1], torch.from_numpy(lab[1]), LAMBDAS)
    assert one[0].shape == (8, 12) and one[2].shape == (6, 1)
    assert torch.equal(one[0], ex[1]) and torch.equal(one[2][:, 0], em[:, 1])


@pytest.mark.parametrize("bad", ["float64", "shape", "labels", "lambdas",
                                 "empty"])
def test_kd_loss_grad_wrapper_rejects_bad_inputs(bad):
    x, y, lab = (torch.from_numpy(a) for a in _logits(2, 4, 10, seed=12))
    lam = LAMBDAS
    if bad == "float64":
        x, y = x.double(), y.double()
    elif bad == "shape":
        y = y[:, :, :9]
    elif bad == "labels":
        lab = lab.float()
    elif bad == "lambdas":
        lam = LAMBDAS[:3]
    else:
        x, y, lab = x[:, :0], y[:, :0], lab[:, :0]
    with pytest.raises((TypeError, ValueError)):
        tkd.kd_loss_grad(x, y, lab, lam)


def test_cpu_calls_of_the_fused_kernels_do_not_count_as_launches():
    before = {**tkd.launches, **trms.launches}
    x, y, lab = (torch.from_numpy(a) for a in _logits(2, 4, 10, seed=13))
    tkd.kd_loss_grad(x, y, lab, LAMBDAS)
    rows = torch.from_numpy(_normal((4, 16), 14))
    trms.add_rmsnorm(rows, rows, torch.ones(16))
    assert {**tkd.launches, **trms.launches} == before


# ---------------------------------------------------------------------- #
# the training step on kd_loss_grad
# ---------------------------------------------------------------------- #
def _autograd_step(apply_local, apply_lite, lr):
    """The step as the reference writes it: autograd through
    mutual_losses."""
    opt = sgd(lr, momentum=0.9)

    def step(params, opt_state, images, labels):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        loss, metrics = tdistill.mutual_losses(
            apply_local(live["local"], images),
            apply_lite(live["lite"], images), labels)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
        metrics["loss"] = loss.detach()
        return tree_add(params, updates), opt_state, metrics
    return step, opt.init


@pytest.mark.parametrize("stacked", [False, True])
def test_one_launch_step_matches_autograd_through_mutual_losses(stacked):
    """Three steps of make_mutual_train_fns' step and of the autograd step
    from the same params give the same params (1e-6) and metrics."""
    pool = jcnn.cnn_pool("mnist")
    cl, cs = pool["lite"], pool["small"]
    jp = {"local": jcnn.init_cnn(jax.random.PRNGKey(0), cs),
          "lite": jcnn.init_cnn(jax.random.PRNGKey(1), cl)}
    params = params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(15)
    C, B = 3, 8
    if stacked:
        params = tree_map(lambda p: p.expand((C,) + p.shape).contiguous(),
                          params)
        apply_local = lambda p, x: tcnn.apply_cnn_fast(p, cs, x)
        apply_lite = lambda p, x: tcnn.apply_cnn_fast(p, cl, x)
        lead = (C, B)
    else:
        apply_local = lambda p, x: tcnn.apply_cnn(p, cs, x)
        apply_lite = lambda p, x: tcnn.apply_cnn(p, cl, x)
        lead = (B,)
    fused, init_opt = tdistill.make_mutual_train_fns(apply_local, apply_lite,
                                                     lr=0.05)
    plain, _ = _autograd_step(apply_local, apply_lite, lr=0.05)
    state = {"fused": (params, init_opt(params)),
             "plain": (params, init_opt(params))}
    for t in range(3):
        images = torch.from_numpy(rng.standard_normal(
            lead + cs.in_shape).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, lead).astype(np.int32))
        metrics = {}
        for name, step in (("fused", fused), ("plain", plain)):
            p, o, metrics[name] = step(*state[name], images, labels)
            state[name] = (p, o)
        assert set(metrics["fused"]) == set(metrics["plain"])
        for k, v in metrics["plain"].items():
            assert metrics["fused"][k].shape == v.shape
            torch.testing.assert_close(metrics["fused"][k], v, atol=1e-6,
                                       rtol=1e-5)
    for a, b in zip(tree_leaves(state["fused"][0]),
                    tree_leaves(state["plain"][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
