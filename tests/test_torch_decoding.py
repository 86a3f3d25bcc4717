"""Parity of the port's decoders (`warp_rnnt_tpu_torch/models/decoding.py`,
`models/beam_search.py`) with the JAX package's, on the CPU.

One Flax `Transducer` tree goes into the JAX model and, through
`carry_flax_transducer`, into the port, in two variants
(`_torch_port_helpers.carried_pair`):
  * "fp32" (encoder and joint in fp32): greedy and beam tokens and lengths
    must be equal; beam scores within 1e-4 (the two frameworks sum the
    same fp32 log-probs; the largest seen was 1.5e-5).
  * "bf16" (the default model): the frameworks round the joint's bf16
    products in other places, so a near tie may go either way and JAX's
    own eager/jit beam scores wobble by ~0.02.  The bf16 decode is held
    on its log-probs: the port's full lattice for its own greedy tokens
    within 4 bf16 ulps of the largest logit of JAX's, and each beam score
    at most the port's Viterbi score of its tokens.
Also: beam 1 equals greedy; `_top_k_small` against JAX's (ties, all--inf
rows, k above the finite entries); the prefix hash against uint32
wrap-around past 2^32; the loop's iteration count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import beam_decode as jax_beam
from warp_rnnt_tpu.models import greedy_decode as jax_greedy
from warp_rnnt_tpu.models.beam_search import _top_k_small as jax_top_k
from warp_rnnt_tpu_torch.functional.alignment import rnnt_alignment
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
from warp_rnnt_tpu_torch.models.beam_search import (
    NEG,
    _HASH_MUL,
    _hash_step,
    _top_k_small,
)
from warp_rnnt_tpu_torch.models.decoding import LOOP_ITERATIONS

N, T, F, V, H, ML = 4, 23, 9, 21, 24, 12
XN = np.array([23, 19, 11, 4], np.int32)
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def setup(request):
    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair(request.param, 2, feats, V, H)
    return request.param, model, params, port, feats


def _port_args(feats):
    return torch.tensor(feats), torch.tensor(XN)


def _np(*xs):
    return [np.asarray(x) for x in xs]


def test_greedy_matches_jax(setup):
    variant, model, params, port, feats = setup
    tok, ln = greedy_decode(port, *_port_args(feats), ML)
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (N, ML)
    if variant == "fp32":
        want = _np(*jax_greedy(model, params, jnp.asarray(feats), XN, ML))
        np.testing.assert_array_equal(ln.numpy(), want[1])
        np.testing.assert_array_equal(tok.numpy(), want[0])
        return
    # bf16: the lattice of the port's own tokens, against JAX's
    L = max(int(ln.max()), 1)
    ys = tok[:, :L]
    with torch.inference_mode():
        got = port(torch.tensor(feats), ys, normalize=False).float().numpy()
    want = np.asarray(model.apply(params, jnp.asarray(feats),
                                  jnp.asarray(ys.numpy()), normalize=False))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


@pytest.mark.parametrize("B", [1, 3, 4])
def test_beam_matches_jax(setup, B):
    variant, model, params, port, feats = setup
    tok, ln, sc = beam_decode(port, *_port_args(feats), ML, beam_size=B)
    assert torch.isfinite(sc).all() and (ln <= ML).all()
    if variant == "fp32":
        want = _np(*jax_beam(model, params, jnp.asarray(feats), XN, ML,
                             beam_size=B))
        np.testing.assert_array_equal(ln.numpy(), want[1])
        np.testing.assert_array_equal(tok.numpy(), want[0])
        np.testing.assert_allclose(sc.numpy(), want[2], rtol=0,
                                   atol=SCORE_ATOL)
        return
    # bf16: one alignment of the tokens, so at most their Viterbi score
    L = max(int(ln.max()), 1)
    with torch.inference_mode():
        lp = port(torch.tensor(feats), tok[:, :L])
    vit, _ = rnnt_alignment(lp, tok[:, :L], torch.tensor(XN), ln)
    assert (sc <= vit + SCORE_ATOL).all(), (sc, vit)


def test_beam_one_equals_greedy(setup):
    _, _, _, port, feats = setup
    g = greedy_decode(port, *_port_args(feats), ML, max_symbols_per_step=3)
    b = beam_decode(port, *_port_args(feats), ML, beam_size=1,
                    max_symbols_per_step=3)
    assert torch.equal(g[1], b[1]) and torch.equal(g[0], b[0])


def test_loop_iterations_are_counted(setup):
    """Each sample takes a step per frame and one per emission; the loop
    runs until the longest is done, so max(xn) to max(xn + ML) steps."""
    _, _, _, port, feats = setup
    LOOP_ITERATIONS["greedy"] = 0
    _, ln = greedy_decode(port, *_port_args(feats), ML)
    assert int(XN.max()) <= LOOP_ITERATIONS["greedy"] <= int(XN.max()) + ML
    LOOP_ITERATIONS["beam"] = 0
    beam_decode(port, *_port_args(feats), ML, beam_size=3)
    assert LOOP_ITERATIONS["beam"] >= int(XN.max())


def _top_k_cases():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 3, 29)))
    x = x.copy()
    x[0, 0, 4] = x[0, 0, 17]  # a tie
    x[0, 1, :] = x[0, 1, 3]  # all tied
    x[1] = NEG  # a dead beam
    x[2, 1, 5:] = NEG
    x[3, 0, :] = -np.inf  # nothing finite
    x[3, 1, 2:] = -np.inf  # two finite
    return x.astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_top_k_small_matches_jax(k):
    x = _top_k_cases()
    v, i = _top_k_small(torch.tensor(x), k)
    vj, ij = _np(*jax_top_k(jnp.asarray(x), k))
    np.testing.assert_array_equal(i.numpy(), ij)
    np.testing.assert_array_equal(v.numpy(), vj)
    for row in i.reshape(-1, k).tolist():  # distinct, even past the finite
        assert len(set(row)) == k


def test_hash_wraps_as_uint32():
    rng = np.random.RandomState(0)
    h = rng.randint(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    h[:3] = [2 ** 32 - 1, 0, 2 ** 31]
    tok = rng.randint(0, 2 ** 20, 1000).astype(np.int32)
    with np.errstate(over="ignore"):
        want = h * np.uint32(_HASH_MUL) + (tok + 1).astype(np.uint32)
    got = _hash_step(torch.tensor(h.astype(np.int64)), torch.tensor(tok))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
