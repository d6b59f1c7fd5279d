"""The limits that chip_smoke.py and tests/test_torch_gpu.py hold
kd_loss_grad to on the card (`chip_smoke.close_kd_grad`), checked on the
CPU with the plain version: they accept its output against the same closed
form computed in float64, and they reject it with one V/16 slice of one
row zeroed, a slice that does not hold the row's label. That is what a
block of a row's cluster that wrote nothing would leave: at B = 2048 its
entries are about (0.4 / 2048) p, which an absolute 1e-4 cannot see.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ref import kd_loss_grad_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import close_kd_grad  # noqa: E402

C, B, V = 1, 64, 32000
LAMBDAS = (0.4, 0.6, 0.5, 0.5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, B, V)) * 3.0).astype(np.float32)
    y = (rng.standard_normal((C, B, V)) * 3.0).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(rng.integers(0, V, (C, B)).astype(np.int32)))


def _closed_form_f64(x, y, labels):
    """kd_loss_grad_ref's formulas in float64, rounded to x's dtype."""
    l1, l2, l3, l4 = LAMBDAS
    xd, yd = x.double(), y.double()
    lab = labels.long()[..., None]
    lse_x = torch.logsumexp(xd, -1, keepdim=True)
    lse_y = torch.logsumexp(yd, -1, keepdim=True)
    p_x, p_y = torch.exp(xd - lse_x), torch.exp(yd - lse_y)
    diff = xd - yd
    e_x = (p_x * diff).sum(-1, keepdim=True)
    e_y = (p_y * -diff).sum(-1, keepdim=True)
    onehot = torch.zeros_like(xd).scatter_(-1, lab, 1.0)
    dx = (l1 / B) * (p_x - onehot) + (l2 / B) * p_x * (diff - e_x)
    dy = (l3 / B) * (p_y - onehot) + (l4 / B) * p_y * (-diff - e_y)
    rows = torch.stack([
        (lse_x - xd.gather(-1, lab))[..., 0],
        (lse_y - yd.gather(-1, lab))[..., 0],
        (e_x - lse_x + lse_y)[..., 0], (e_y - lse_y + lse_x)[..., 0],
        (x.argmax(-1) == labels).double(), (y.argmax(-1) == labels).double()])
    return dx.to(x.dtype), dy.to(y.dtype), rows.mean(-1).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_limit_accepts_the_plain_version(dtype):
    """The fp32 plain version's rounding, against float64, is within the
    limit; so is the bf16 one (one bf16 ulp of each element)."""
    x, y, lab = (t.to(dtype) if t.is_floating_point() else t
                 for t in _inputs(0))
    close_kd_grad(torch, kd_loss_grad_ref(x, y, lab, LAMBDAS),
                  _closed_form_f64(x, y, lab), f"plain {dtype}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", [0, 1])
def test_limit_rejects_a_zeroed_slice(seed, which):
    """dx (which 0) or dy (1) of the plain version with the V/16 slice
    three slices past the label's zeroed in row 5: rejected."""
    x, y, lab = _inputs(seed)
    exp = kd_loss_grad_ref(x, y, lab, LAMBDAS)
    got = [t.clone() for t in exp]
    width = V // 16
    k = (int(lab[0, 5]) // width + 3) % 16
    got[which][0, 5, k * width:(k + 1) * width] = 0.0
    with pytest.raises(AssertionError):
        close_kd_grad(torch, got, exp, "zeroed slice")
    close_kd_grad(torch, exp, exp, "unchanged")


def test_limit_rejects_a_wrong_accuracy():
    """The accuracies must be exact: one row's hit more is rejected."""
    x, y, lab = _inputs(2)
    exp = kd_loss_grad_ref(x, y, lab, LAMBDAS)
    got = [t.clone() for t in exp]
    got[2][4, 0] += 1.0 / B
    with pytest.raises(AssertionError, match="accuracies"):
        close_kd_grad(torch, got, exp, "accuracy")
