"""Numerical contract of the PyTorch port against the JAX package, on the
CPU (counterpart of `tests/test_numerics.py`):

  * a lattice cell whose blank and label log-probs are both -inf: the CUDA
    lattice kernels' twin (what ``impl="cuda"`` runs on a CPU tensor) gives
    the finite costs and gradients of JAX's ``impl="scan"`` (costs rtol
    1e-5, gradients within 1e-5 of their largest entry); the kernel against
    its twin on the card is marked `cuda`;
  * the forward/backward canary: a disagreeing sample's gradients are
    zeroed and its cost averaged, exactly as JAX's `costs_and_grads` does;
  * ``WARP_RNNT_DEBUG=1`` warns when the canary trips, and only then.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device, tt  # noqa: F401  (fixture)
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu.functional import postprocess as jax_post
from warp_rnnt_tpu_torch.functional import postprocess
from warp_rnnt_tpu_torch.ops import cuda_impl


def _neg_inf_cell_inputs():
    """Log-softmax of seed-0 normals (numpy's default generator), N=2, T=6,
    U=4, V=7, xn=(6, 5), yn=(3, 2), with every entry of cell (n=0, t=2,
    u=1) set to -inf: its blank and its label log-prob are both -inf."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 7))
    xs = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    ys = rng.integers(1, 7, (2, 3)).astype(np.int32)
    xs[0, 2, 1, :] = -np.inf
    return xs, ys, np.array([6, 5], np.int32), np.array([3, 2], np.int32)


def _jax_costs_grads(xs, ys, xn, yn):
    def f(x):
        c = warp_rnnt_tpu.rnnt_loss(x, jnp.asarray(ys), jnp.asarray(xn),
                                    jnp.asarray(yn), impl="scan")
        return c.sum(), c
    (_, costs), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(xs))
    return np.asarray(costs), np.asarray(grad)


def _port_costs_grads(xs, ys, xn, yn, impl, device="cpu"):
    x = torch.tensor(xs, device=device, requires_grad=True)
    costs = wt.rnnt_loss(x, *(t.to(device) for t in tt(ys, xn, yn)), impl=impl)
    costs.sum().backward()
    return costs.detach().cpu().numpy(), x.grad.cpu().numpy()


@pytest.mark.parametrize("impl", ["cuda", "scan"])
def test_neg_inf_cell_matches_jax_scan(impl):
    """The cell's two -inf log-probs meet in one logaddexp; the kernel twin
    reads them as the -1e30 sentinel and stays finite, as the scan does."""
    xs, ys, xn, yn = _neg_inf_cell_inputs()
    want_c, want_g = _jax_costs_grads(xs, ys, xn, yn)
    got_c, got_g = _port_costs_grads(xs, ys, xn, yn, impl)
    assert np.isfinite(got_c).all() and np.isfinite(got_g).all()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    np.testing.assert_allclose(got_c[0], 13.585902, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=0,
                               atol=1e-5 * np.abs(want_g).max())


def test_twin_reads_neg_inf_as_the_sentinel():
    """The twin's alphas and betas on valid cells are finite at the -inf
    cell and bit-equal with the same cell set to -1e30 (the sentinel)."""
    xs, ys, xn, yn = _neg_inf_cell_inputs()
    lab = np.concatenate([ys, np.zeros((2, 1), np.int32)], 1)
    blank = xs[..., 0]
    emit = np.take_along_axis(xs, lab[:, None, :, None].repeat(6, 1), -1)[..., 0]
    args = tt(np.ascontiguousarray(blank), np.ascontiguousarray(emit), xn, yn)
    got = cuda_impl.alpha_beta(*args)
    sent = [a.clone() for a in args[:2]]
    for s in sent:
        s[torch.isinf(s)] = cuda_impl.NEG
    want = cuda_impl.alpha_beta(*sent, *args[2:])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)


def _canary_inputs():
    """`tests/test_numerics.py`'s lattice: sample 1's alpha at its terminal
    cell is corrupted, so ll_forward = -11 against ll_backward = -3."""
    N, T, U = 2, 3, 2
    blank = np.full((N, T, U), -1.0, np.float32)
    emit = np.full((N, T, U), -1.5, np.float32)
    alphas = np.full((N, T, U), -2.0, np.float32)
    betas = np.full((N, T, U), -2.0, np.float32)
    betas[:, 0, 0] = -3.0
    alphas[1, 2, 1] = -10.0
    return blank, emit, alphas, betas, np.array([3, 3], np.int32), np.array(
        [1, 1], np.int32)


def test_mismatch_zeroes_grads_and_averages_cost():
    """Port of `test_numerics.py:15`: |ll_f - ll_b| / |max| > 0.001 zeroes
    the sample's gradients and averages its cost, as JAX does."""
    args = _canary_inputs()
    costs, gb, ge = postprocess.costs_and_grads(*tt(*args), 0.0)
    jc, jgb, jge = jax_post.costs_and_grads(*map(jnp.asarray, args), 0.0)
    np.testing.assert_allclose(float(costs[0]), 3.0, rtol=1e-6)
    np.testing.assert_allclose(float(costs[1]), (11.0 + 3.0) / 2, rtol=1e-6)
    assert gb[0].abs().max() > 0
    assert not gb[1].any() and not ge[1].any()
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-6)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=1e-6)


def test_canary_mask_and_debug_warning(monkeypatch):
    """Port of `test_numerics.py:38`: with WARP_RNNT_DEBUG=1 a tripped check
    warns, naming the flagged samples (a RuntimeWarning here, where JAX
    prints from inside jit), and `mismatch_mask` reports them; a healthy
    batch does not warn."""
    monkeypatch.setenv("WARP_RNNT_DEBUG", "1")
    blank, emit, alphas, betas, xn, yn = _canary_inputs()
    bad = postprocess.mismatch_mask(*tt(blank, alphas, betas, xn, yn))
    assert bad.tolist() == [False, True]
    with pytest.warns(RuntimeWarning, match=r"mismatch.*mask=\[False, True\]"):
        _, gb, _ = postprocess.costs_and_grads(
            *tt(blank, emit, alphas, betas, xn, yn), 0.0)
    assert not gb[1].any()

    alphas[1, 2, 1] = -2.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        postprocess.costs_and_grads(*tt(blank, emit, alphas, betas, xn, yn), 0.0)
    monkeypatch.setenv("WARP_RNNT_DEBUG", "0")
    alphas[1, 2, 1] = -10.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        postprocess.costs_and_grads(*tt(blank, emit, alphas, betas, xn, yn), 0.0)


@pytest.mark.cuda
def test_neg_inf_cell_kernel_matches_twin_on_card(cuda_device):
    """The lattice kernel on the card against its twin on the card: both
    finite, costs rtol 1e-5 and gradients within 1e-5 of their largest
    entry; and against JAX's scan on the CPU."""
    xs, ys, xn, yn = _neg_inf_cell_inputs()
    got_c, got_g = _port_costs_grads(xs, ys, xn, yn, "cuda", cuda_device)
    twin_c, twin_g = _port_costs_grads(xs, ys, xn, yn, "cuda")
    want_c, _ = _jax_costs_grads(xs, ys, xn, yn)
    assert np.isfinite(got_c).all() and np.isfinite(got_g).all()
    np.testing.assert_allclose(got_c, twin_c, rtol=1e-5)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    np.testing.assert_allclose(got_g, twin_g, rtol=0,
                               atol=1e-5 * np.abs(twin_g).max())
