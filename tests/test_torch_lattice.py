"""Parity of the PyTorch port's lattice layer with the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and its port:
  * `scan_impl` against `warp_rnnt_tpu.functional.scan_impl` (rtol = atol =
    1e-5; alphas/betas on valid cells, costs and grads everywhere);
  * the plain twin of the CUDA lattice kernel against the Pallas kernels in
    interpret mode (1e-5 on valid cells), at T within and past 256 frames;
  * the twin in float32 against the twin in float64, the kernel's launch
    geometry (`lattice_plan`), and the twin's column solve (the kernel's
    order) against the recurrence taken one position at a time;
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
from warp_rnnt_tpu_torch.benchmarks import flat_write_cases as fwc
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


@pytest.mark.parametrize("compute_alpha", [True, False])
def test_twin_alpha_beta_matches_pallas_long(compute_alpha):
    """T past 256 frames (the old kernel's chunk) and U past one warp."""
    blank, emit, xn, yn = _lattice(10, N=3, T=300, U=34, V=5)
    ta, tb = cuda_impl.alpha_beta(*tt(blank, emit, xn, yn), compute_alpha)
    ja, jb = pallas_impl.alpha_beta(
        jnp.asarray(blank), jnp.asarray(emit), jnp.asarray(xn), jnp.asarray(yn),
        compute_alpha=compute_alpha, interpret=True,
    )
    _assert_valid_close(tb.numpy(), jb, xn, yn)
    if compute_alpha:
        _assert_valid_close(ta.numpy(), ja, xn, yn)


@pytest.mark.parametrize("compute_alpha", [True, False])
def test_twin_float64_matches_float32(compute_alpha):
    blank, emit, xn, yn = _lattice(11, N=5, T=40, U=9)
    args = tt(blank, emit, xn, yn)
    a32, b32 = cuda_impl.alpha_beta_plain(*args, compute_alpha)
    a64, b64 = cuda_impl.alpha_beta_plain(*args, compute_alpha,
                                          dtype=torch.float64)
    assert b32.dtype == torch.float32 and b64.dtype == torch.float64
    _assert_valid_close(b32.numpy(), b64.numpy(), xn, yn)
    if compute_alpha:
        _assert_valid_close(a32.numpy(), a64.numpy(), xn, yn)
    else:
        assert a64 is None


@pytest.mark.parametrize("T", [1, 31, 33, 150, 1024, 1100, 1473, 9000])
def test_lattice_plan(T):
    """Every position of every segment belongs to one lane; no warp is idle
    in the first segment; the block fits the card's threads."""
    plan = cuda_impl.lattice_plan(T)
    rows = 32 * plan.frames * plan.warps
    assert 1 <= plan.frames <= cuda_impl.MAX_FRAMES
    assert 1 <= plan.warps <= cuda_impl.MAX_WARPS
    assert plan.segments == -(-T // rows)
    assert (plan.segments - 1) * rows < T <= plan.segments * rows
    if plan.segments == 1:
        assert (plan.warps - 1) * 32 * plan.frames < T  # each warp has a frame
        assert plan.frames == -(-T // (32 * cuda_impl.MAX_WARPS))


def test_lattice_plan_rejects_empty():
    with pytest.raises(ValueError):
        cuda_impl.lattice_plan(0)


@pytest.mark.parametrize("T", [1, 31, 33, 150, 1100, 9000])
def test_solve_in_kernel_order_solves_the_recurrence(T):
    """The twin's column solve, in the kernel's order (lanes, warps,
    segments), equals the recurrence a[j] = LSE(a[j-1] + m[j], b[j]) taken
    one position at a time, in float64."""
    rng = np.random.RandomState(T)
    m = torch.tensor(rng.randn(2, T) - 1.0)
    b = torch.tensor(rng.randn(2, T) - 3.0)
    b[1, T // 2:] = cuda_impl.NEG  # sentinel cells inside a warp
    want = torch.empty_like(m)
    a = b[:, 0]
    want[:, 0] = a
    for j in range(1, T):
        a = cuda_impl._lae(a + m[:, j], b[:, j])
        want[:, j] = a
    np.testing.assert_allclose(cuda_impl._solve(m, b).numpy(), want.numpy(),
                               rtol=1e-12, atol=0)


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
    ((3, 600, 4), [600, 333, 257], [3, 1, 2]),  # T = 600: 19 warps
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


def _card_lattice(seed, N, T, U, xn=None, yn=None):
    """A seeded lattice and lengths (random in [T/2, T] and [0, U-1], the
    first sample full, unless given) as CPU tensors."""
    rng = np.random.RandomState(seed)
    lp = torch.log_softmax(torch.tensor(rng.randn(N, T, U, 3).astype(np.float32)), -1)
    if xn is None:
        xn = rng.randint(T // 2, T + 1, size=N)
        yn = rng.randint(0, U, size=N)
        xn[0], yn[0] = T, U - 1
    return [lp[..., 0].contiguous(), lp[..., 1].contiguous(),
            torch.tensor(xn, dtype=torch.int32), torch.tensor(yn, dtype=torch.int32)]


# Long lattices are held against the twin in float64: past ~600 frames the
# float32 twin's own rounding nears the tolerance.
LONG_CASES = {
    "T=1100": dict(N=4, T=1100, U=9),               # > 32 x 32, not a multiple of 32
    "B": dict(N=16, T=1473, U=299),                 # compact case B's lattice
    "U=1": dict(N=3, T=40, U=1, xn=[40, 1, 17], yn=[0, 0, 0]),
    "segments": dict(N=2, T=9000, U=5),             # past 32 warps x 8 frames
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LONG_CASES))
@pytest.mark.parametrize("compute_alpha", [True, False])
def test_lattice_kernel_matches_float64_twin(cuda_device, case, compute_alpha):
    args = _card_lattice(12, **LONG_CASES[case])
    pa, pb = cuda_impl.alpha_beta_plain(*args, compute_alpha, dtype=torch.float64)
    ka, kb = cuda_impl.alpha_beta(*(a.to(cuda_device) for a in args), compute_alpha)
    xn, yn = args[2].numpy(), args[3].numpy()
    _assert_valid_close(kb.cpu().double().numpy(), pb.numpy(), xn, yn)
    if compute_alpha:
        _assert_valid_close(ka.cpu().double().numpy(), pa.numpy(), xn, yn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B", "full_width"])
def test_lattice_kernel_is_deterministic(cuda_device, case):
    """Two calls give bit-equal alphas and betas (no atomics in the
    arithmetic)."""
    dims = LONG_CASES["B"] if case == "B" else dict(
        N=32, T=150, U=21, xn=[150] * 32, yn=[20] * 32)
    args = [a.to(cuda_device) for a in _card_lattice(13, **dims)]
    for compute_alpha in (True, False):
        first = cuda_impl.alpha_beta(*args, compute_alpha)
        second = cuda_impl.alpha_beta(*args, compute_alpha)
        for x, y in zip(first, second):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("T,U", [(150, 21), (1473, 299), (9000, 5), (40, 1)])
def test_lattice_kernel_attrs(cuda_device, T, U):
    """No spills; the staged tile is a power of two of at most 8 columns,
    no wider than U needs; the block stays within the shared-memory budget,
    and within the default 48 KB at the main path's lattice."""
    attrs = cuda_impl.kernel_attrs(T, U)
    cols = attrs["tile_cols"]
    assert attrs["spill_bytes"] == 0
    assert cols & (cols - 1) == 0 and cols <= 8 and (cols < 2 * U or cols == 1)
    assert attrs["dynamic_smem"] <= 200 * 1024
    if (T, U) == (150, 21):
        assert attrs["dynamic_smem"] <= 48 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fwc.CASES))
def test_flat_write_kernel_matches_twin(cuda_device, name):
    """The kernel against its plain twin bit for bit, NaN rows alike, on
    every case of `benchmarks/flat_write_cases.py` (V 1 to 5000, among them
    128 and 131, in fp32, fp64, fp16 and bf16; column offsets)."""
    r = fwc.compare(flat_kernels, name, device=cuda_device)
    assert r["max_abs_err"] == 0.0
