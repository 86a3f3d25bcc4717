"""Parity of the port's Viterbi alignment
(`warp_rnnt_tpu_torch/functional/alignment.py`) with the JAX package's and
with the brute-force path enumeration of `tests/test_alignment.py`, on
the CPU.

Frames must be equal; scores agree within rtol 1e-5 (the doubling scan
adds the same log-probs as JAX's associative scan, in another order).
Covered: pre-gathered ``blank=-1`` input against the brute force, the
(N, T, U, V) input with ragged lengths, a long lattice (T=400, where a
cumsum rewrite's cancellation would flip the backtrace), another blank
index, and the Viterbi score at most the full-sum log-likelihood.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from test_alignment import brute_force_best_path
from warp_rnnt_tpu.functional.alignment import rnnt_alignment as jax_alignment
from warp_rnnt_tpu_torch import rnnt_alignment, rnnt_loss

RTOL = 1e-5


def _both(xs, ys, xn, yn, blank=0):
    want = jax_alignment(*map(jnp.asarray, (xs, ys, xn, yn)), blank=blank)
    got = rnnt_alignment(*map(torch.tensor, (xs, ys, xn, yn)), blank=blank)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_match(got, want):
    (s, f), (sw, fw) = got, want
    assert f.dtype == np.int32 and f.shape == fw.shape
    np.testing.assert_array_equal(f, fw)
    np.testing.assert_allclose(s, sw, rtol=RTOL)


def test_pregathered_matches_brute_force_and_jax():
    rng = np.random.RandomState(0)
    N, T, U = 5, 5, 4
    blank_lp = np.log(rng.rand(N, T, U).astype(np.float32))
    emit_lp = np.log(rng.rand(N, T, U).astype(np.float32))
    xn = np.array([5, 4, 5, 3, 5], np.int32)
    yn = np.array([3, 2, 0, 3, 1], np.int32)
    xs = np.stack([blank_lp, emit_lp], -1)
    ys = np.zeros((N, U - 1), np.int32)
    got, want = _both(xs, ys, xn, yn, blank=-1)
    _assert_match(got, want)
    scores, frames = got
    for n in range(N):
        best, best_frames = brute_force_best_path(blank_lp[n], emit_lp[n],
                                                  int(xn[n]), int(yn[n]))
        np.testing.assert_allclose(scores[n], best, rtol=RTOL)
        assert list(frames[n][: yn[n]]) == best_frames
        assert (frames[n][yn[n]:] == -1).all()


@pytest.mark.parametrize("seed,T,U,V,blank", [(1, 6, 4, 7, 0), (2, 23, 9, 11, 3),
                                              (3, 400, 21, 9, 0)])
def test_vocab_input_matches_jax(seed, T, U, V, blank):
    rng = np.random.RandomState(seed)
    N = 4
    xs = golden.log_softmax(rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(0, V, (N, U - 1)).astype(np.int32)
    xn = np.array([T, T - 1, T // 2 + 1, 1], np.int32)
    yn = np.array([U - 1, U // 2, 1, 0], np.int32)
    got, want = _both(xs, ys, xn, yn, blank=blank)
    _assert_match(got, want)
    frames = got[1]
    for n in range(N):  # monotone, inside the frames
        valid = frames[n][: yn[n]]
        assert (valid >= 0).all() and (np.diff(valid) >= 0).all()
        assert (valid < xn[n]).all()


def test_score_at_most_the_log_likelihood():
    rng = np.random.RandomState(4)
    N, T, U, V = 4, 12, 5, 7
    xs = golden.log_softmax(rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([12, 10, 7, 12], np.int32)
    yn = np.array([4, 3, 2, 0], np.int32)
    args = tuple(map(torch.tensor, (xs, ys, xn, yn)))
    scores, _ = rnnt_alignment(*args)
    costs = rnnt_loss(*args)
    assert (scores <= -costs + 1e-5).all()
