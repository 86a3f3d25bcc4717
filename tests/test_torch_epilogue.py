"""The post-sweep epilogue of the PyTorch port (`ops.cuda_impl.epilogue`,
`csrc/lattice.cu`'s `epilogue_kernel`) against the JAX package.

On the CPU the epilogue runs its plain version, `epilogue_plain`: the torch
code of `functional/postprocess.costs_and_grads` written to strided outputs
in the output dtype.  It is held against JAX's `costs_and_grads` followed by
the stack and cast of JAX's core (`jnp.stack(..., -1).astype(dtype)`), on
the same seeded numpy inputs: costs and the canary's mask bit for bit (no
exp reaches them), fp32 gradients within 2e-6 of their largest (torch's and
XLA's exp differ in the last bits), bf16 and fp16 gradients within one
unit in the last place.  Inputs and outputs at element stride 1 (planes) and
2 (the channels of (N, T, U, 2) tensors).  The main path's loss+grad, which
now runs the sweep on the interleaved lattice and the epilogue into the
interleaved gradient, is held against JAX's scan under `jax.value_and_grad`
within PERF.md's tolerances; the lattice's and the write's stride 2 against
stride 1 bit for bit; and the card's comparisons
(`benchmarks/epilogue_cases.py`) run here with both sides plain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device, loss_inputs, tt  # noqa: F401
import warp_rnnt_tpu
from warp_rnnt_tpu.functional import postprocess as jax_post
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.benchmarks import epilogue_cases as ec
from warp_rnnt_tpu_torch.functional import core
from warp_rnnt_tpu_torch.ops import cuda_impl, flat_kernels

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


def _edges(seed=0):
    """`epilogue_cases`' edge case as numpy arrays: xn = 0, yn >= U, a
    tripped canary, -inf and NaN log-probs."""
    blank, emit, alphas, betas, xn, yn, lam = ec.make_case(
        "edges", cuda_impl, device="cpu", seed=seed)
    return tuple(x.numpy() for x in (blank, emit, alphas, betas, xn, yn)), lam


def _jax_epilogue(args, lam, dtype):
    costs, gb, ge = jax_post.costs_and_grads(*map(jnp.asarray, args), lam)
    mask = jax_post.mismatch_mask(*map(jnp.asarray, (args[0], *args[2:])))
    grads = jnp.stack([gb, ge], axis=-1).astype(JNP[dtype])
    return (np.asarray(costs), np.asarray(mask),
            torch.from_numpy(np.array(grads.astype(jnp.float32))).to(dtype))


def _port_epilogue(args, lam, dtype, stride):
    blank, emit, alphas, betas, xn, yn = tt(*args)
    if stride == 2:
        blank, emit, _ = ec.interleaved(blank, emit)
    g0, g1, whole = ec.outputs(tuple(alphas.shape), dtype, stride, "cpu")
    costs, bad = cuda_impl.epilogue(blank, emit, alphas, betas, xn, yn, lam,
                                    g0, g1)
    grads = whole if stride == 2 else torch.stack([g0, g1], dim=-1)
    return costs.numpy(), bad.numpy(), grads


def _same_bits(got, want):
    """Equal float32 bits, NaN where the other has NaN."""
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _ulps(got, want):
    """Largest distance in units of the last place between two tensors of a
    16-bit float dtype, NaN positions required to agree (0 there)."""
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    a = got.view(torch.int16).int()
    b = want.view(torch.int16).int()
    # sign-magnitude to a monotone integer line
    a = torch.where(a < 0, -(a & 0x7FFF), a)
    b = torch.where(b < 0, -(b & 0x7FFF), b)
    return int((a - b).abs().masked_fill(nan, 0).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_epilogue_plain_matches_jax(lam, dtype, stride):
    args, _ = _edges(seed=1)
    costs, bad, grads = _port_epilogue(args, lam, dtype, stride)
    jcosts, jbad, jgrads = _jax_epilogue(args, lam, dtype)
    assert bad.tolist() == jbad.tolist()
    assert bad[3] and not bad[0]  # the perturbed beta trips, a full one not
    _same_bits(costs, jcosts)
    assert grads.dtype == dtype and grads.shape == (*args[0].shape, 2)
    if dtype == torch.float32:
        nan = grads.isnan()
        assert torch.equal(nan, jgrads.isnan())
        scale = float(jgrads.masked_fill(nan, 0).abs().max())
        err = float((grads - jgrads).masked_fill(nan, 0).abs().max())
        assert err <= 2e-6 * scale
    else:
        assert _ulps(grads, jgrads) <= 1
    # the canary's sample: every gradient a zero; xn = 0: none valid
    assert not grads[3].float().abs().max() and not grads[1].float().abs().max()


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_epilogue_plain_matches_jax_on_a_ragged_sweep(lam):
    """Alphas and betas of a real sweep (no edits), ragged lengths, fp32
    planes: the values the main path's epilogue sees."""
    blank, emit, xn, yn = ec.make_lattice(5, 23, 7, seed=2, device="cpu")
    alphas, betas = cuda_impl.alpha_beta(blank, emit, xn, yn)
    args = tuple(x.numpy() for x in (blank, emit, alphas, betas, xn, yn))
    costs, bad, grads = _port_epilogue(args, lam, torch.float32, 1)
    jcosts, jbad, jgrads = _jax_epilogue(args, lam, torch.float32)
    assert not bad.any() and not jbad.any()
    _same_bits(costs, jcosts)
    scale = float(jgrads.abs().max())
    assert float((grads - jgrads).abs().max()) <= 2e-6 * scale


@pytest.mark.parametrize("impl", ["cuda", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_gradient_layout(impl, dtype):
    """The core's gradient comes back (N, T, U, 2) in the lattice's dtype
    through the epilogue's strided route ("cuda": the kernel's route, plain
    on the CPU) and the scan's stack and cast alike, equal to the plain
    epilogue written to planes and stacked; `rnnt_core_with_internals`
    gives it in fp32."""
    xs, ys, xn, yn = loss_inputs(21, N=4, T=9, U=5, V=6)
    blank = xs[..., 0]
    lat = torch.tensor(np.stack([blank, xs[..., 1]], axis=-1)).to(dtype)
    xn_t, yn_t = tt(xn, yn)
    costs, grads, alphas, betas = core._forward_backward_gathered(
        lat, xn_t, yn_t, 0.3, impl)
    assert grads.shape == lat.shape and grads.dtype == dtype
    f = lat.float()
    c1, gb, ge, _, _ = core._forward_backward(
        f[..., 0].contiguous(), f[..., 1].contiguous(), xn_t, yn_t, 0.3, impl)
    assert torch.equal(costs, c1)
    assert torch.equal(grads, torch.stack([gb, ge], dim=-1).to(dtype))
    c2, g2, _, _ = core.rnnt_core_with_internals(lat, xn_t, yn_t, 0.3, impl)
    assert g2.dtype == torch.float32 and g2.shape == lat.shape
    assert torch.equal(c2, costs) and torch.equal(g2.to(dtype), grads)


@pytest.mark.parametrize("fastemit", [0.0, 0.3])
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_main_path_matches_jax_scan(layout, fastemit):
    """`rnnt_loss(..., gather=True, impl="cuda")` on CPU tensors (the card's
    route with plain kernels: the gather, the sweep on the interleaved
    lattice, the epilogue into the interleaved gradient, the write from the
    interleaved cotangent) against JAX's scan: costs rtol 1e-5, gradient
    within 5e-3 of its largest (PERF.md section 2)."""
    xs, ys, xn, yn = loss_inputs(22, N=4, T=12, U=5, V=7)
    N, T, U, V = xs.shape
    lp = xs if layout == "4d" else xs.reshape(N, T, U * V)
    x = torch.tensor(lp, requires_grad=True)
    kw = dict(fastemit_lambda=fastemit, reduction="mean")
    out = wt.rnnt_loss(x, *tt(ys, xn, yn), gather=True, impl="cuda", **kw)
    out.backward()
    costs = wt.rnnt_loss(torch.tensor(lp), *tt(ys, xn, yn), gather=True,
                         impl="cuda", fastemit_lambda=fastemit)
    jout, jgrad = jax.value_and_grad(
        lambda z: warp_rnnt_tpu.rnnt_loss(z, jnp.asarray(ys), xn, yn,
                                          impl="scan", **kw)
    )(jnp.asarray(lp))
    jcosts = warp_rnnt_tpu.rnnt_loss(jnp.asarray(lp), jnp.asarray(ys), xn, yn,
                                     impl="scan", fastemit_lambda=fastemit)
    np.testing.assert_allclose(float(out.detach()), float(jout), rtol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    assert x.grad.shape == x.shape
    err = np.abs(x.grad.numpy() - jgrad).max()
    assert err <= 5e-3 * np.abs(jgrad).max()


@pytest.mark.parametrize("name", ["edges", "main"])
def test_lattice_stride_two_equals_stride_one(name):
    assert ec.lattice_strides(cuda_impl, name, device="cpu") == 0.0


@pytest.mark.parametrize("name", ["V=50 fp32", "V=5000 bf16", "V=131 fp16"])
def test_write_stride_two_equals_stride_one(name):
    assert ec.write_strides(flat_kernels, name, device="cpu") == {
        "kernel": 0.0, "plain": 0.0}


def test_strided_layouts_are_checked():
    """A plane that is neither contiguous nor a channel of a contiguous
    (N, T, U, 2) tensor is refused by name; the two strides are told
    apart."""
    from warp_rnnt_tpu_torch.ops import _build

    x = torch.zeros(3, 4, 5, 2)
    assert _build.elem_stride(x[..., 0], "x") == 2
    assert _build.elem_stride(x[..., 0].contiguous(), "x") == 1
    assert _build.elem_stride(x.transpose(1, 2)[..., 0]) is None
    with pytest.raises(ValueError, match="g_blank must be contiguous"):
        _build.elem_stride(torch.zeros(3, 5, 4).transpose(1, 2), "g_blank")


@pytest.mark.parametrize("name", ["edges", "main"])
def test_card_comparison_runs_on_cpu(name):
    """`epilogue_cases.compare` with both sides plain: the card's check's
    code, and the plain version equal to itself at every dtype and
    stride."""
    r = ec.compare(cuda_impl, name, device="cpu")
    assert all(v == 0.0 for k, v in r.items() if k != "mask")
    if name == "edges":
        assert r["mask"][3] and not r["mask"][0]


def test_debug_warning_from_the_strided_route(monkeypatch):
    """``WARP_RNNT_DEBUG=1``: the main path's route warns where the canary
    trips, naming the mask, as `costs_and_grads` does."""
    monkeypatch.setenv("WARP_RNNT_DEBUG", "1")
    blank, emit, alphas, betas, xn, yn, lam = ec.make_case(
        "edges", cuda_impl, device="cpu")
    calls = []
    real = cuda_impl.alpha_beta

    def perturbed(*a, **k):
        out = real(*a, **k)
        out[1][3, 0, 0] *= 1.01
        calls.append(1)
        return out

    monkeypatch.setattr(cuda_impl, "alpha_beta", perturbed)
    lat = torch.stack([blank, emit], -1)
    with pytest.warns(RuntimeWarning, match=r"mismatch.*mask=\[False, "):
        cuda_impl.forward_backward_gathered(lat, xn, yn, lam)
    assert calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_epilogue_kernel_matches_plain(cuda_device, name):  # noqa: F811
    r = ec.compare(cuda_impl, name, device="cuda")
    assert all(v == 0.0 for k, v in r.items() if k != "mask")
    assert ec.lattice_strides(cuda_impl, "edges") == 0.0
    assert ec.write_strides(flat_kernels, "V=50 fp32")["kernel"] == 0.0
