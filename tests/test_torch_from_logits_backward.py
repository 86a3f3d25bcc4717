"""The backward of the port's `rnnt_loss_from_logits`
(`warp_rnnt_tpu_torch/functional/from_logits.py`) writes its fp32
temporary with the subtraction itself, ``torch.sub(x4, logZ)``, instead of
a copy of the logits to fp32 and a subtraction in place.  On the CPU:

  * the gradient equals, bit for bit, the one of the copy-then-subtract
    formulation (the backward as it was written before, kept here as
    `_copy_then_subtract`), in fp32, bf16 and fp16, 4-D and flat, with
    FastEmit and a blank that is not 0; fp64 logits still round to fp32
    first;
  * `rnnt_loss_from_logits` still matches JAX's (``impl="scan"``) within
    the tolerance of `tests/test_torch_from_logits.py` (costs rtol 1e-5,
    the gradient rtol 1e-4, atol 1e-6), in fp32 and in bf16 (JAX's bf16
    gradient comes back in bf16; both are held in fp32 there, within a
    bf16 ulp of the larger).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.functional import from_logits

TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_from_logits.py
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16, "fp64": torch.float64}


def _case(seed=0, N=4, T=11, U=5, V=9):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    xn = rng.randint(U, T + 1, size=(N,)).astype(np.int32)
    yn = rng.randint(1, U, size=(N,)).astype(np.int32)
    return logits, ys, xn, yn


def _copy_then_subtract(ctx, ct):
    """`_LogitsCore.backward` as it was: a copy of the logits to fp32, then
    the subtraction of logZ in place."""
    x4, loc_rows, logz, g_blank, g_emit = ctx.saved_tensors
    N, T, U, _ = x4.shape
    ctb = ct.float()[:, None, None]
    d = x4.to(torch.float32, copy=True)
    d.sub_(logz[..., None]).exp_()
    d.mul_(-(ctb * (g_blank + g_emit))[..., None])
    d[..., ctx.blank] += ctb * g_blank
    idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
    d.scatter_add_(3, idx, (ctb * g_emit)[..., None])
    return d.to(x4.dtype), None, None, None, None, None, None


def _grad(x, ys, xn, yn, **kw):
    x = x.detach().clone().requires_grad_()
    w = torch.linspace(0.5, 1.5, x.shape[0])
    out = wt.rnnt_loss_from_logits(x, ys, xn, yn, **kw)
    (out * w).sum().backward()
    return out.detach(), x.grad


@pytest.mark.parametrize("kw", [{}, {"fastemit_lambda": 0.3}, {"blank": 3}],
                         ids=["plain", "fastemit", "blank3"])
@pytest.mark.parametrize("layout", ["4d", "flat"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gradient_equals_the_copy_formulation(dtype, layout, kw, monkeypatch):
    logits, ys, xn, yn = _case(seed=5)
    if kw.get("blank") == 3:
        ys[ys == 3] = 4
    x = torch.tensor(logits).to(DTYPES[dtype])
    if layout == "flat":
        x = x.reshape(x.shape[0], x.shape[1], -1)
    args = (torch.tensor(ys), torch.tensor(xn), torch.tensor(yn))
    out, grad = _grad(x, *args, **kw)
    monkeypatch.setattr(from_logits._LogitsCore, "backward",
                        staticmethod(_copy_then_subtract))
    ref_out, ref_grad = _grad(x, *args, **kw)
    assert grad.dtype == x.dtype and grad.shape == x.shape
    assert torch.equal(out, ref_out)
    assert torch.equal(grad, ref_grad), (grad.double() - ref_grad.double()
                                         ).abs().max()
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_from_logits_still_matches_jax(dtype):
    logits, ys, xn, yn = _case(seed=7)
    tdtype = DTYPES[dtype]
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    x = torch.tensor(logits).to(tdtype)
    out, grad = _grad(x, torch.tensor(ys), torch.tensor(xn), torch.tensor(yn))
    w = np.linspace(0.5, 1.5, logits.shape[0]).astype(np.float32)

    def jloss(z):
        o = warp_rnnt_tpu.rnnt_loss_from_logits(z, jnp.asarray(ys), xn, yn,
                                                impl="scan")
        return (o * w).sum(), o

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits).astype(jdtype))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout, np.float32),
                               rtol=1e-5)
    got = grad.float().numpy()
    want = np.asarray(jgrad.astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= ulp + TOL["atol"]).all()
