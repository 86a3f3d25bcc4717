"""Parity of the port's alignment-restricted loss
(`warp_rnnt_tpu_torch/functional/restricted.py`) with the JAX package's, on
the CPU, ``impl="scan"`` on both sides.

The same numpy inputs (the batch of `tests/test_restricted.py`, label
frames from JAX's `rnnt_alignment`) go through both.  Costs agree within
rtol 1e-5 and gradients within 1e-5 of their largest entry: the two scans
run the same fp32 recurrence in another order of sums.  Covered: each
reduction with and without ``average_frames``, FastEmit, pre-gathered
``blank=-1`` input, the twin of the CUDA path (``impl="cuda"`` on a CPU
tensor), the huge band (equal to `rnnt_loss`), the zero band (the Viterbi
score), and both halves of the infeasible-band contract (+inf and exactly
zero, finite gradients under 'none'; 'sum'/'mean' without the infeasible
samples; an all-infeasible batch 0.0 with zero gradients).  The card's
kernel path is held in `tests/test_torch_serving_card.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from warp_rnnt_tpu import rnnt_alignment as jax_alignment
from warp_rnnt_tpu import rnnt_loss as jax_rnnt_loss
from warp_rnnt_tpu.functional.loss import _gather_blank_emit as jax_gather
from warp_rnnt_tpu.functional.restricted import rnnt_loss_restricted as jax_r
from warp_rnnt_tpu_torch import rnnt_loss, rnnt_loss_restricted
from warp_rnnt_tpu_torch.functional.restricted import NEG, band_mask

RTOL = 1e-5
REDUCTIONS = ("none", "sum", "mean")


def _batch(seed):
    """`tests/test_restricted.py`'s batch and its Viterbi label frames."""
    rng = np.random.RandomState(seed)
    N, T, U, V = 4, 10, 5, 7
    xs = golden.log_softmax(rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    xn = np.array([10, 8, 10, 7], np.int32)
    yn = np.array([4, 2, 3, 4], np.int32)
    _, frames = jax_alignment(*map(jnp.asarray, (xs, ys, xn, yn)))
    return xs, ys, xn, yn, np.asarray(frames)


@pytest.fixture(scope="module")
def batch():
    return _batch(5)


@pytest.fixture(scope="module")
def bad_batch():
    """Seed 11 with sample 0's bands out of order (label 1 at frame 8,
    the others at frame 0, zero context), as the JAX tests put them."""
    xs, ys, xn, yn, frames = _batch(11)
    bad = frames.copy()
    bad[0, 0] = 8
    bad[0, 1:] = 0
    return xs, ys, xn, yn, bad


def _jax(xs, ys, xn, yn, frames, l, r, **kw):
    """(costs, gradient of their sum) of the JAX function on the scan."""
    def f(z):
        return jnp.sum(jax_r(z, ys, xn, yn, frames, l, r, impl="scan", **kw))

    costs = jax_r(jnp.asarray(xs), ys, xn, yn, frames, l, r, impl="scan", **kw)
    return np.asarray(costs), np.asarray(jax.grad(f)(jnp.asarray(xs)))


def _port(xs, ys, xn, yn, frames, l, r, impl="scan", **kw):
    x = torch.tensor(xs, requires_grad=True)
    costs = rnnt_loss_restricted(x, *map(torch.tensor, (ys, xn, yn, frames)),
                                 l, r, impl=impl, **kw)
    costs.sum().backward()
    return costs.detach().numpy(), x.grad.numpy()


def _assert_match(got, want):
    (c, g), (cw, gw) = got, want
    np.testing.assert_allclose(c, cw, rtol=RTOL)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, gw, rtol=0, atol=RTOL * np.abs(gw).max())


@pytest.mark.parametrize("average_frames", [False, True])
@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_matches_jax(batch, reduction, average_frames):
    kw = dict(reduction=reduction, average_frames=average_frames)
    _assert_match(_port(*batch, 2, 1, **kw), _jax(*batch, 2, 1, **kw))


@pytest.mark.parametrize("impl", ["scan", "cuda"])
def test_fastemit_matches_jax(batch, impl):
    """FastEmit, on the scan and on the CUDA path's plain twin."""
    kw = dict(reduction="none", fastemit_lambda=0.3)
    _assert_match(_port(*batch, 3, 2, impl=impl, **kw), _jax(*batch, 3, 2, **kw))


def test_pregathered_input_matches_jax(batch):
    xs, ys, xn, yn, frames = batch
    g = np.asarray(jax_gather(jnp.asarray(xs), jnp.asarray(ys), 0))
    kw = dict(reduction="none", blank=-1)
    _assert_match(_port(g, ys, xn, yn, frames, 3, 2, **kw),
                  _jax(g, ys, xn, yn, frames, 3, 2, **kw))
    np.testing.assert_allclose(_port(g, ys, xn, yn, frames, 3, 2, **kw)[0],
                               _port(*batch, 3, 2, reduction="none")[0],
                               rtol=1e-6)


def test_huge_band_equals_unrestricted(batch):
    xs, ys, xn, yn, frames = batch
    got = _port(xs, ys, xn, yn, frames, 1000, 1000, reduction="none")[0]
    want = rnnt_loss(*map(torch.tensor, (xs, ys, xn, yn)), impl="scan")
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(jax_rnnt_loss(
        *map(jnp.asarray, (xs, ys, xn, yn)), impl="scan")), rtol=RTOL)


def test_zero_band_is_the_viterbi_path():
    """With l = r = 0 around the Viterbi alignment one path remains: the
    restricted cost is minus its score."""
    xs, ys, xn, yn, _ = _batch(3)
    scores, frames = jax_alignment(*map(jnp.asarray, (xs, ys, xn, yn)))
    got = _port(xs, ys, xn, yn, np.asarray(frames), 0, 0, reduction="none")[0]
    np.testing.assert_allclose(got, -np.asarray(scores), rtol=RTOL)


def test_band_mask_is_exactly_the_sentinel(batch):
    """Out of band the emit channel is exactly NEG; row U-1's band is that
    of a label at frame 0, as in JAX."""
    xs, ys, xn, yn, frames = batch
    g = torch.rand(4, 10, 5, 2)
    m = band_mask(g, torch.tensor(frames), 2, 1)
    t = torch.arange(10)[None, :, None]
    f = torch.cat([torch.tensor(frames), torch.zeros(4, 1, dtype=torch.int32)], 1)
    in_band = (t >= f[:, None, :] - 2) & (t <= f[:, None, :] + 1)
    assert torch.equal(m[..., 0], g[..., 0])
    assert torch.equal(m[..., 1][in_band], g[..., 1][in_band])
    assert (m[..., 1][~in_band] == NEG).all()


@pytest.mark.parametrize("impl", ["scan", "cuda"])
def test_infeasible_sample_is_inf_with_zero_grads(bad_batch, impl):
    """'none': +inf, exactly zero and finite gradients; the feasible
    samples as JAX's."""
    costs, grads = _port(*bad_batch, 0, 0, impl=impl, reduction="none")
    want_c, want_g = _jax(*bad_batch, 0, 0, reduction="none")
    assert np.isposinf(costs[0]) and np.isposinf(want_c[0])
    assert np.isfinite(costs[1:]).all()
    np.testing.assert_allclose(costs[1:], want_c[1:], rtol=RTOL)
    assert np.isfinite(grads).all()
    assert (grads[0] == 0).all() and (grads[1] != 0).any()
    np.testing.assert_allclose(grads, want_g, rtol=0,
                               atol=RTOL * np.abs(want_g).max())


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("impl", ["scan", "cuda"])
def test_infeasible_sample_left_out_of_reductions(bad_batch, reduction, impl):
    costs, grads = _port(*bad_batch, 0, 0, impl=impl, reduction=reduction)
    per = _port(*bad_batch, 0, 0, impl=impl, reduction="none")[0][1:]
    want = per.sum() if reduction == "sum" else per.mean()
    np.testing.assert_allclose(costs, want, rtol=1e-6)
    _assert_match((costs, grads), _jax(*bad_batch, 0, 0, reduction=reduction))
    assert (grads[0] == 0).all() and (grads[1] != 0).any()


@pytest.mark.parametrize("impl", ["scan", "cuda"])
def test_all_infeasible_batch_is_zero(impl):
    xs, ys, xn, yn, frames = _batch(11)
    bad = frames.copy()
    bad[:, 0] = 8
    bad[:, 1:] = 0
    costs, grads = _port(xs, ys, xn, yn, bad, 0, 0, impl=impl,
                         reduction="mean")
    assert float(costs) == 0.0 and (grads == 0).all()


def test_no_grad_route_matches(batch):
    """Without a gradient the beta-only route gives the same costs."""
    xs, ys, xn, yn, frames = batch
    args = (*map(torch.tensor, (xs, ys, xn, yn, frames)), 2, 1)
    with torch.no_grad():
        for impl in ("scan", "cuda"):
            got = rnnt_loss_restricted(*args, impl=impl)
            np.testing.assert_allclose(got.numpy(), _jax(*batch, 2, 1)[0],
                                       rtol=RTOL)


def test_validation(batch):
    xs, ys, xn, yn, frames = map(torch.tensor, batch)
    with pytest.raises(ValueError, match="Unknown reduction"):
        rnnt_loss_restricted(xs, ys, xn, yn, frames, reduction="avg")
    with pytest.raises(ValueError, match=r"label_frames must have shape"):
        rnnt_loss_restricted(xs, ys, xn, yn, frames[:, :2])
