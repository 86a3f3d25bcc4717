"""Parity of the PyTorch port's lattice layer with the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and its port:
  * `scan_impl` against `warp_rnnt_tpu.functional.scan_impl` (rtol = atol =
    1e-5; alphas/betas on valid cells, costs and grads everywhere);
  * the plain twin of the CUDA lattice kernels against the Pallas kernels in
    interpret mode (1e-5 on valid cells);
  * the plain twin of the CUDA gradient write against the Pallas writer in
    interpret mode (exact).
Kernel-against-twin tests need the card and are marked `cuda`.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    gathered,
    loss_inputs,
    tt,
    valid_cells,
)
from warp_rnnt_tpu.functional import scan_impl as jax_scan
from warp_rnnt_tpu.ops import flat_kernels as jax_flat
from warp_rnnt_tpu.ops import pallas_impl
from warp_rnnt_tpu_torch.functional import scan_impl
from warp_rnnt_tpu_torch.ops import _build, cuda_impl, flat_kernels
from warp_rnnt_tpu_torch.utils.lse import logrec_combine, safe_logaddexp

TOL = dict(rtol=1e-5, atol=1e-5)


def _lattice(seed, **shape):
    xs, ys, xn, yn = loss_inputs(seed, **shape)
    blank, emit = gathered(xs, ys)
    return blank, emit, xn, yn


def _assert_valid_close(got, want, xn, yn):
    mask = valid_cells(xn, yn, *got.shape[1:])
    np.testing.assert_allclose(np.asarray(got)[mask], np.asarray(want)[mask], **TOL)


def test_safe_logaddexp_at_neg_inf():
    a = torch.tensor([float("-inf"), float("-inf"), 0.5, -3.0])
    b = torch.tensor([float("-inf"), 1.0, float("-inf"), -2.0])
    out = safe_logaddexp(a, b)
    np.testing.assert_allclose(out.numpy(), np.logaddexp(a.numpy(), b.numpy()),
                               rtol=1e-6)
    assert not torch.isnan(out).any()
    m, s = logrec_combine((torch.tensor(0.0), torch.tensor(float("-inf"))),
                          (torch.tensor(2.0), torch.tensor(-1.0)))
    assert float(m) == 2.0 and float(s) == -1.0  # (0, -inf) is the identity


@pytest.mark.parametrize("fastemit", [0.0, 0.25])
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_impl_matches_jax(seed, fastemit):
    blank, emit, xn, yn = _lattice(seed)
    got = scan_impl.forward_backward(*tt(blank, emit, xn, yn), fastemit)
    want = jax_scan.forward_backward(jnp.asarray(blank), jnp.asarray(emit),
                                     jnp.asarray(xn), jnp.asarray(yn), fastemit)
    for g, w in zip(got[:3], want[:3]):  # costs, grad_blank, grad_emit
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(got[3:], want[3:]):  # alphas, betas
        _assert_valid_close(g.numpy(), w, xn, yn)
    c = scan_impl.costs_only(*tt(blank, emit, xn, yn))
    np.testing.assert_allclose(c.numpy(), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("compute_alpha", [True, False])
def test_twin_alpha_beta_matches_pallas(compute_alpha):
    blank, emit, xn, yn = _lattice(2, N=3, T=13, U=5)
    ta, tb = cuda_impl.alpha_beta(*tt(blank, emit, xn, yn), compute_alpha)
    ja, jb = pallas_impl.alpha_beta(
        jnp.asarray(blank), jnp.asarray(emit), jnp.asarray(xn), jnp.asarray(yn),
        compute_alpha=compute_alpha, interpret=True,
    )
    _assert_valid_close(tb.numpy(), jb, xn, yn)
    if compute_alpha:
        _assert_valid_close(ta.numpy(), ja, xn, yn)
    else:
        assert ta is None and ja is None


@pytest.mark.parametrize("fastemit", [0.0, 0.25])
def test_twin_forward_backward_matches_scan(fastemit):
    blank, emit, xn, yn = _lattice(3)
    got = cuda_impl.forward_backward(*tt(blank, emit, xn, yn), fastemit)
    want = jax_scan.forward_backward(jnp.asarray(blank), jnp.asarray(emit),
                                     jnp.asarray(xn), jnp.asarray(yn), fastemit)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    c = cuda_impl.costs_only(*tt(blank, emit, xn, yn))
    np.testing.assert_allclose(c.numpy(), np.asarray(want[0]), **TOL)


def _write_inputs(seed, N=2, T=3, U=4, V=131):
    rng = np.random.RandomState(seed)
    ct0 = rng.randn(N, T, U).astype(np.float32)
    ct1 = rng.randn(N, T, U).astype(np.float32)
    loc = rng.randint(0, V, size=(N, U)).astype(np.int32)
    loc[:, -1] = 0  # the last row's label is the blank: both terms add
    loc[0, 1] = 0
    return ct0, ct1, loc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [128, 131])
def test_twin_flat_write_matches_pallas(V, dtype):
    ct0, ct1, loc = _write_inputs(4, V=V)
    U = loc.shape[1]
    got = flat_kernels.flat_grad_write(*tt(ct0, ct1, loc), 0, V, U * V,
                                       getattr(torch, dtype))
    want = jax_flat.flat_grad_write(jnp.asarray(ct0), jnp.asarray(ct1),
                                    jnp.asarray(loc), 0, V, U * V,
                                    out_dtype=getattr(jnp, dtype), interpret=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_flat_write_adds_where_label_is_blank():
    ct0, ct1, loc = _write_inputs(5, V=9)
    N, T, U = ct0.shape
    d = flat_kernels.flat_grad_write(*tt(ct0, ct1, loc), 0, 9, U * 9).view(N, T, U, 9)
    np.testing.assert_array_equal(d[:, :, -1, 0].numpy(), ct0[:, :, -1] + ct1[:, :, -1])
    assert int((d != 0).sum(-1).max()) <= 2


@pytest.mark.parametrize("case", ["emit_shape", "lengths_shape", "empty"])
def test_lattice_wrapper_checks_raise(case):
    blank, emit, xn, yn = tt(*_lattice(6, N=2, T=4, U=3))
    if case == "emit_shape":
        emit = emit[:, :, :2]
    elif case == "lengths_shape":
        xn = xn[:1]
    else:
        blank, emit = blank[:, :0], emit[:, :0]
    with pytest.raises(ValueError):
        cuda_impl.alpha_beta(blank, emit, xn, yn)


@pytest.mark.parametrize("case", ["ct_dtype", "loc_shape", "uv", "blank"])
def test_flat_write_checks_raise(case):
    ct0, ct1, loc = tt(*_write_inputs(7, V=9))
    U, V, blank = loc.shape[1], 9, 0
    UV = U * V
    if case == "ct_dtype":
        ct0 = ct0.double()
    elif case == "loc_shape":
        loc = loc[:, :-1]
    elif case == "uv":
        UV += 1
    else:
        blank = V
    with pytest.raises(ValueError):
        flat_kernels.flat_grad_write(ct0, ct1, loc, blank, V, UV)


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    """A failing nvcc raises with its stderr; nothing falls back."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 3\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.build_all()
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,xn,yn", [
    ((6, 37, 9), [37, 20, 1, 37, 5, 30], [8, 3, 0, 8, 0, 5]),
    ((3, 600, 4), [600, 333, 257], [3, 1, 2]),  # T above one 256-thread chunk
])
@pytest.mark.parametrize("compute_alpha", [True, False])
def test_lattice_kernel_matches_twin(cuda_device, shape, xn, yn, compute_alpha):
    rng = np.random.RandomState(8)
    N, T, U = shape
    lp = torch.log_softmax(torch.tensor(rng.randn(N, T, U, 3).astype(np.float32)), -1)
    args = [lp[..., 0].contiguous(), lp[..., 1].contiguous(),
            torch.tensor(xn, dtype=torch.int32), torch.tensor(yn, dtype=torch.int32)]
    pa, pb = cuda_impl.alpha_beta_plain(*args, compute_alpha)
    ka, kb = cuda_impl.alpha_beta(*(a.to(cuda_device) for a in args), compute_alpha)
    xn, yn = np.array(xn), np.array(yn)
    _assert_valid_close(kb.cpu().numpy(), pb.numpy(), xn, yn)
    if compute_alpha:
        _assert_valid_close(ka.cpu().numpy(), pa.numpy(), xn, yn)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("V", [128, 131])
def test_flat_write_kernel_matches_twin(cuda_device, V, dtype):
    args = tt(*_write_inputs(9, V=V))
    U = args[2].shape[1]
    want = flat_kernels.flat_grad_write_plain(*args, 0, V, U * V, dtype)
    got = flat_kernels.flat_grad_write(*(a.to(cuda_device) for a in args),
                                       0, V, U * V, dtype)
    assert torch.equal(got.cpu(), want)
