"""The port's device loop (`warp_rnnt_tpu_torch/utils/device_loop.py`)
and the decoders' drains on it, against ``jax.lax.while_loop`` and the
JAX package's drains, on the CPU (where the loop's rounds run eagerly:
the plain version of the CUDA graph).

  * `while_loop` against ``jax.lax.while_loop`` on a toy loop whose body
    changes a field even where every sample is done (as greedy's
    ``last_tok``), with ragged trip counts (none among them), at unroll 1,
    2 and 5: the whole state, the trip count and the host reads
    (max(1, ceil(trips / unroll))); ``max_iterations`` one short of the
    trips raises; the caller's state is not written; a loop without a
    ``key`` (which keys the graph cache on the card) raises.
  * `decoding.pad_frames`: the frames' axis padded to a power of two
    gives every `frame_at` read the frame it gave before, bit for bit.
  * The port's `greedy_drain` and `beam_drain` against JAX's on the same
    encoder frames (JAX's), fp32 and bf16 models
    (`_torch_port_helpers.carried_pair`), at unroll 1, 3 and 8: the whole
    state tuple; tokens and every integer field exact, float fields within
    `test_torch_decoding.py`'s 1e-4.
  * Ten surplus masked steps after the end leave every field bit for bit.
  * A streaming session chunked at C=7 equals the one-shot decode at
    unroll 3, greedy and beam; host reads at most ceil(iterations /
    unroll) + 1 a decode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import beam_search as jax_beam_search
from warp_rnnt_tpu.models import decoding as jax_decoding
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    init_model,
    stream_finish,
    stream_init,
    stream_step,
)
from warp_rnnt_tpu_torch.models import beam_search, decoding
from warp_rnnt_tpu_torch.utils import device_loop

N, T, F, V, H, ML, B = 4, 23, 9, 21, 24, 12, 3
XN = np.array([23, 19, 11, 4], np.int32)
FLOAT_ATOL = 1e-4  # test_torch_decoding.py's SCORE_ATOL
MOD = 1000003

# toy trip counts: ragged, all equal, none, one sample far past the rest
LIMITS = {"ragged": [0, 3, 7, 10], "equal": [5, 5, 5, 5], "none": [0, 0, 0, 0],
          "one": [1, 0, 12, 2]}


def _toy_torch():
    def cond(state, consts):
        return (state[0] < consts[0]).any()

    def body(state, consts):
        i, acc, calls = state
        on = i < consts[0]
        return (torch.where(on, i + 1, i), (acc * 3 + i + 1) % MOD, calls + 1)

    return cond, body


def _toy_jax(lim):
    def cond(state):
        return jnp.any(state[0] < lim)

    def body(state):
        i, acc, calls, trips = state
        on = i < lim
        return (jnp.where(on, i + 1, i), (acc * 3 + i + 1) % MOD, calls + 1,
                trips + 1)

    return cond, body


def _toy_state(lim):
    rng = np.random.RandomState(len(lim))
    return (np.zeros(4, np.int32), rng.randint(0, MOD, 4).astype(np.int32),
            np.zeros((), np.int32))


@pytest.mark.parametrize("unroll", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(LIMITS))
def test_while_loop_matches_jax(case, unroll):
    lim = np.array(LIMITS[case], np.int32)
    init = _toy_state(lim)
    *want, trips = jax.lax.while_loop(*_toy_jax(jnp.asarray(lim)),
                                      (*map(jnp.asarray, init), 0))
    state = tuple(torch.tensor(x) for x in init)
    saved = tuple(x.clone() for x in state)
    with device_loop.unrolled(unroll):
        got, stats = device_loop.while_loop(
            *_toy_torch(), state, (torch.tensor(lim),),
            max_iterations=int(lim.max()), key="toy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert stats.iterations == int(trips) == int(lim.max())
    assert stats.host_reads == max(1, math.ceil(int(trips) / unroll))
    assert all(torch.equal(a, b) for a, b in zip(state, saved))


@pytest.mark.parametrize("unroll", [1, 3, 4])
def test_while_loop_past_its_bound_raises(unroll):
    """10 trips against a bound of 9: caught where cond still holds at a
    read (unroll 1, 3) and where the round ran past it (unroll 4)."""
    lim = np.array(LIMITS["ragged"], np.int32)
    state = tuple(torch.tensor(x) for x in _toy_state(lim))
    with pytest.raises(RuntimeError, match="past its bound of 9"):
        with device_loop.unrolled(unroll):
            device_loop.while_loop(*_toy_torch(), state,
                                   (torch.tensor(lim),), max_iterations=9,
                                   key="toy")
    with pytest.raises(ValueError):
        with device_loop.unrolled(0):
            pass


def test_while_loop_without_a_key_raises():
    """On the card a cached graph replays the cond and body of its first
    capture, so a loop must name them; the rule holds on every device."""
    lim = np.array(LIMITS["ragged"], np.int32)
    state = tuple(torch.tensor(x) for x in _toy_state(lim))
    with pytest.raises(ValueError, match="key"):
        device_loop.while_loop(*_toy_torch(), state, (torch.tensor(lim),),
                               max_iterations=10, key=None)


@pytest.mark.parametrize("C", [0, 1, 5, 8, 9, 23])
def test_pad_frames_reads_the_same_frames(C):
    enc = torch.tensor(np.random.RandomState(C).randn(3, C, 4)
                       .astype(np.float32))
    padded = decoding.pad_frames(enc)
    width = padded.shape[1]
    assert width >= max(C, 1) and width & (width - 1) == 0
    assert width < 2 * max(C, 1)
    assert torch.equal(padded[:, :C], enc)
    if C == 0:
        return
    p0 = 5
    for pos in range(p0 - 2, p0 + 2 * width + 2):
        t = torch.full((3,), pos, dtype=torch.int32)
        assert torch.equal(decoding.frame_at(padded, t, p0),
                           decoding.frame_at(enc, t, p0))


def _unmasked_steps_change_the_toy():
    """The surplus test's teeth: the toy body itself changes a finished
    state, so only the mask keeps it."""
    cond, body = _toy_torch()
    lim = torch.tensor(LIMITS["ragged"], dtype=torch.int32)
    done = (lim.clone(), torch.zeros(4, dtype=torch.int32),
            torch.zeros((), dtype=torch.int32))
    assert not bool(cond(done, (lim,)))
    return not all(torch.equal(a, b) for a, b in zip(body(done, (lim,)), done))


def test_surplus_steps_leave_the_toy_state():
    assert _unmasked_steps_change_the_toy()
    lim = torch.tensor(LIMITS["ragged"], dtype=torch.int32)
    state = tuple(torch.tensor(x) for x in _toy_state(lim.numpy()))
    with device_loop.unrolled(1):
        done, _ = device_loop.while_loop(*_toy_torch(), state, (lim,),
                                         max_iterations=10, key="toy")
    with device_loop.unrolled(10):
        again, stats = device_loop.while_loop(*_toy_torch(), done, (lim,),
                                              max_iterations=10, key="toy")
    assert stats[:2] == (0, 1) and stats.graph is None
    assert all(torch.equal(a, b) for a, b in zip(again, done))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def drains(request):
    """(port model, JAX's encoder frames as a torch tensor, JAX's final
    greedy and beam-B states)."""
    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair(request.param, 2, feats, V, H)
    bound = model.bind(params)
    enc = bound.encode(jnp.asarray(feats))
    greedy = jax_decoding.greedy_drain(
        bound, jax_decoding.greedy_state_init(bound, N, ML), enc, 0, XN)
    beam = jax_beam_search.beam_drain(
        bound, jax_beam_search.beam_state_init(bound, N, B, ML), enc, 0, XN)
    return port, torch.tensor(np.asarray(enc)), greedy, beam


def _port_drain(port, enc, name, state=None):
    if name == "greedy":
        state = state or decoding.greedy_state_init(port, N, ML)
        return decoding.greedy_drain(port, state, enc, 0, torch.tensor(XN))
    state = state or beam_search.beam_state_init(port, N, B, ML)
    return beam_search.beam_drain(port, state, enc, 0, torch.tensor(XN))


def _assert_state_matches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=FLOAT_ATOL)
        else:  # JAX's hash is uint32, the port's int64 in [0, 2^32)
            np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                          w.astype(np.int64))


@pytest.mark.parametrize("unroll", [1, 3, 8])
@pytest.mark.parametrize("name", ["greedy", "beam"])
def test_drain_matches_jax_on_the_whole_state(drains, name, unroll):
    port, enc, greedy, beam = drains
    with device_loop.unrolled(unroll):
        got = _port_drain(port, enc, name)
    _assert_state_matches(got, greedy if name == "greedy" else beam)


@pytest.mark.parametrize("name", ["greedy", "beam"])
def test_ten_surplus_steps_leave_the_state(drains, name):
    """A drain of a finished state takes one round of ten masked steps, in
    which cond never holds: every field stays bit for bit."""
    port, enc, _, _ = drains
    done = _port_drain(port, enc, name)
    decoding.LOOP_ITERATIONS[name] = decoding.HOST_READS[name] = 0
    with device_loop.unrolled(10):
        again = _port_drain(port, enc, name, done)
    assert decoding.LOOP_ITERATIONS[name] == 0
    assert decoding.HOST_READS[name] == 1
    for a, b in zip(again, done):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("unroll", [3, 8])
def test_host_reads_per_decode(drains, unroll):
    port, _, _, _ = drains
    feats = torch.tensor(np.random.RandomState(0).randn(N, T, F)
                         .astype(np.float32))
    for name, decode in (("greedy", greedy_decode), ("beam", beam_decode)):
        decoding.LOOP_ITERATIONS[name] = decoding.HOST_READS[name] = 0
        with device_loop.unrolled(unroll):
            decode(port, feats, torch.tensor(XN), ML)
        iterations = decoding.LOOP_ITERATIONS[name]
        assert iterations >= int(XN.max())
        assert decoding.HOST_READS[name] <= math.ceil(iterations / unroll) + 1


def test_streaming_chunked_equals_one_shot_at_unroll_3():
    S_N, S_T, S_ML = 4, 41, 30
    model, _, _ = init_model(0, vocab_size=V, feat_dim=F, N=S_N, T=S_T, U=5,
                             device="cpu", encoder_hidden=H,
                             predictor_hidden=H, joint_hidden=H)
    feats = torch.tensor(np.random.RandomState(1).randn(S_N, S_T, F)
                         .astype(np.float32))
    xn = torch.tensor([41, 33, 17, 5], dtype=torch.int32)
    with device_loop.unrolled(3):
        for beam in (0, B):
            if beam:
                want = beam_decode(model, feats, xn, S_ML, beam_size=beam)
            else:
                want = greedy_decode(model, feats, xn, S_ML)
            st = stream_init(model, S_N, S_ML, beam_size=beam)
            for i in range(0, S_T, 7):
                st = stream_step(model, st, feats[:, i:i + 7], xn=xn)
            got = stream_finish(model, st, xn=xn)[:-1]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
