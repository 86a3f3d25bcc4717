"""Parity of the PyTorch port's `rnnt_loss_from_logits` with the JAX
package, on the CPU.

The same seeded numpy logits go through JAX's `rnnt_loss_from_logits`
(``impl="scan"``) and the port: costs at rtol 1e-5 and the gradient through
the folded softmax at rtol 1e-4, atol 1e-6 (the two packages' fp32 doubling
scans round differently, which leaves up to a few 1e-5 of relative error in
an occupancy exp(alpha + lp + beta - ll) with |ll| ~ 1e2), 4-D and flat
3-D, every reduction, ``average_frames`` and FastEmit; the port's fused
form against its own log_softmax + `rnnt_loss`; the golden costs; the no-grad route; the input dtype; the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from _torch_port_helpers import tt
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.functional import from_logits

TOL = dict(rtol=1e-4, atol=1e-6)


def _case(seed=0, N=4, T=11, U=5, V=9):
    """Inputs of `tests/test_from_logits._case`, as numpy."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, T, U, V).astype(np.float32)
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    xn = rng.randint(U, T + 1, size=(N,)).astype(np.int32)
    yn = rng.randint(1, U, size=(N,)).astype(np.int32)
    return logits, ys, xn, yn


def _both(logits, ys, xn, yn, **kw):
    """(costs, grad) of the port and of JAX under a weighted sum."""
    w = np.random.RandomState(1).rand(logits.shape[0]).astype(np.float32)
    none = kw.get("reduction", None) in (None, "none")
    x = torch.tensor(logits, requires_grad=True)
    out = wt.rnnt_loss_from_logits(x, *tt(ys, xn, yn), **kw)
    (out * torch.tensor(w) if none else out).sum().backward()

    def jloss(z):
        o = warp_rnnt_tpu.rnnt_loss_from_logits(z, jnp.asarray(ys), xn, yn,
                                                impl="scan", **kw)
        return (o * w if none else o).sum(), o

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    return (out.detach().numpy(), x.grad.numpy()), (np.asarray(jout),
                                                    np.asarray(jgrad))


@pytest.mark.parametrize("average_frames", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_matches_jax(layout, reduction, average_frames):
    logits, ys, xn, yn = _case(seed=3)
    if layout == "flat":
        logits = logits.reshape(logits.shape[0], logits.shape[1], -1)
    (out, grad), (jout, jgrad) = _both(logits, ys, xn, yn, reduction=reduction,
                                       average_frames=average_frames)
    np.testing.assert_allclose(out, jout, rtol=1e-5)
    assert grad.shape == logits.shape
    np.testing.assert_allclose(grad, jgrad, **TOL)


@pytest.mark.parametrize("blank,fastemit,V", [(0, 0.4, 9), (3, 0.0, 9),
                                              (0, 0.0, 300)])
def test_options_match_jax(blank, fastemit, V):
    logits, ys, xn, yn = _case(seed=4, V=V)
    ys[ys == blank] = blank + 1
    (out, grad), (jout, jgrad) = _both(logits, ys, xn, yn, blank=blank,
                                       fastemit_lambda=fastemit)
    np.testing.assert_allclose(out, jout, rtol=1e-5)
    np.testing.assert_allclose(grad, jgrad, **TOL)


def test_matches_log_softmax_composition():
    """The folded softmax gives log_softmax + the port's rnnt_loss: value
    rtol 1e-5, gradient rtol 5e-4 (the tolerance of
    `tests/test_from_logits.py`)."""
    logits, ys, xn, yn = _case(seed=5)
    args = tt(ys, xn, yn)
    x0 = torch.tensor(logits, requires_grad=True)
    v0 = wt.rnnt_loss(torch.log_softmax(x0, -1), *args, reduction="sum")
    v0.backward()
    x1 = torch.tensor(logits, requires_grad=True)
    v1 = wt.rnnt_loss_from_logits(x1, *args, reduction="sum")
    v1.backward()
    np.testing.assert_allclose(float(v1.detach()), float(v0.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(x1.grad.numpy(), x0.grad.numpy(), rtol=5e-4,
                               atol=1e-5)


def test_golden_from_logits():
    raw = np.asarray(golden._FWD_BATCH_XS, dtype=np.float32)
    case = golden.FORWARD_BATCH
    costs = wt.rnnt_loss_from_logits(
        torch.tensor(raw), *tt(case["ys"], case["xn"], case["yn"]))
    np.testing.assert_allclose(costs.numpy(), case["expected_costs"],
                               rtol=1e-4, atol=2e-5)


def test_no_grad_route_runs_beta_only(monkeypatch):
    logits, ys, xn, yn = _case(seed=6)
    args = tt(ys, xn, yn)
    x = torch.tensor(logits, requires_grad=True)
    train = wt.rnnt_loss_from_logits(x, *args).detach()

    def _boom(*a, **k):
        raise AssertionError("alpha+grads sweep ran")

    monkeypatch.setattr(from_logits, "_forward_backward", _boom)
    with torch.no_grad():
        inf = wt.rnnt_loss_from_logits(x, *args)
    np.testing.assert_allclose(inf.numpy(), train.numpy(), rtol=1e-6)


def test_input_dtype_is_kept():
    logits, ys, xn, yn = _case(seed=7)
    ref = torch.tensor(logits, requires_grad=True)
    wt.rnnt_loss_from_logits(ref, *tt(ys, xn, yn), reduction="sum").backward()
    x = torch.tensor(logits).to(torch.bfloat16).requires_grad_()
    out = wt.rnnt_loss_from_logits(x, *tt(ys, xn, yn), reduction="sum")
    out.backward()
    assert out.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), ref.grad.numpy(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("case,exc,match", [
    ("reduction", ValueError, "Unknown reduction method"),
    ("ndim", ValueError, "logits must have 4 dimensions"),
    ("flat_divisible", ValueError, "is not divisible by U"),
    ("labels_shape", ValueError, "labels must have shape"),
    ("contiguous", RuntimeError, "logits must be contiguous"),
])
def test_errors(case, exc, match):
    logits, ys, xn, yn = _case(seed=8, N=2, T=3, U=3, V=4)
    x, kw = torch.tensor(logits), {}
    labels = torch.tensor(ys)
    if case == "reduction":
        kw["reduction"] = "avg"
    elif case == "ndim":
        x = x[0, 0]
    elif case == "flat_divisible":
        x = x.reshape(2, 3, 12)[..., :11].contiguous()
    elif case == "labels_shape":
        labels = labels[:, :1]
    else:
        x = x.transpose(1, 2)
    with pytest.raises(exc, match=match):
        wt.rnnt_loss_from_logits(x, labels, *tt(xn, yn), **kw)
