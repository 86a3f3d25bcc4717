"""The port's streaming session (`warp_rnnt_tpu_torch/models/streaming.py`)
on the CPU: chunked equals one-shot, exactly, and the session equals
JAX's.

The exactness contract of `tests/test_streaming.py`, held on the port's
default bf16 model: any chunking (C = 1, 3, 7, 41, ragged lengths and
tail) gives `greedy_decode`'s tokens and lengths, and a beam session (C =
5, 16) `beam_decode`'s tokens, lengths and scores, bit for bit; a state
stopped midway, sent through numpy and resumed, gives the same.  Against
JAX's session on the fp32 variant (`_torch_port_helpers.carried_pair`):
tokens and lengths equal, beam scores within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import stream_finish as jax_finish
from warp_rnnt_tpu.models import stream_init as jax_init
from warp_rnnt_tpu.models import stream_step as jax_step
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    init_model,
    stream_finish,
    stream_init,
    stream_step,
)

N, T, F, V, H, ML = 4, 41, 9, 21, 24, 30
XN = [41, 33, 17, 5]  # ragged


@pytest.fixture(scope="module")
def setup():
    model, _, _ = init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=5,
                             device="cpu", encoder_hidden=H,
                             predictor_hidden=H, joint_hidden=H)
    feats = torch.tensor(np.random.RandomState(1).randn(N, T, F)
                         .astype(np.float32))
    return model, feats


def _stream_all(model, feats, C, xn=None, beam=0, step=stream_step,
                init=stream_init, finish=stream_finish):
    st = init(model, N, max_length=ML, beam_size=beam)
    for i in range(0, feats.shape[1], C):
        st = step(model, st, feats[:, i:i + C], xn=xn)
    return finish(model, st, xn=xn)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("C", [1, 3, 7, 41])
def test_chunked_equals_one_shot_greedy(setup, C):
    model, feats = setup
    xn = torch.tensor(XN, dtype=torch.int32)
    want = greedy_decode(model, feats, xn, ML)
    got = _stream_all(model, feats, C, xn=xn)
    assert set(got[2]) == {"enc", "dec"}
    _equal(got[:2], want)


@pytest.mark.parametrize("C", [5, 16])
def test_chunked_equals_one_shot_beam(setup, C):
    model, feats = setup
    xn = torch.tensor(XN, dtype=torch.int32)
    want = beam_decode(model, feats, xn, ML, beam_size=3)
    got = _stream_all(model, feats, C, xn=xn, beam=3)
    assert set(got[3]) == {"enc", "dec_beam"}
    _equal(got[:3], want)


@pytest.mark.parametrize("beam", [0, 3])
def test_state_resumes_midway(setup, beam):
    """The state is tensors: stopped after 20 frames, sent through numpy
    (as a checkpoint would) and resumed, it decodes as one-shot."""
    model, feats = setup
    xn = torch.full((N,), T, dtype=torch.int32)
    if beam:
        want = beam_decode(model, feats, xn, ML, beam_size=beam)
    else:
        want = greedy_decode(model, feats, xn, ML)
    st = stream_init(model, N, ML, beam_size=beam)
    st = stream_step(model, st, feats[:, :20])

    def through_numpy(x):
        if isinstance(x, torch.Tensor):  # bf16 caches cross as fp32
            return torch.tensor(x.float().numpy()).to(x.dtype)
        if isinstance(x, dict):
            return {k: through_numpy(v) for k, v in x.items()}
        return type(x)(through_numpy(v) for v in x)

    st = stream_step(model, through_numpy(st), feats[:, 20:])
    _equal(stream_finish(model, st)[:-1], want)


@pytest.mark.parametrize("beam", [0, 3])
def test_session_matches_jax_fp32(beam):
    feats = np.random.RandomState(2).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair("fp32", 3, feats, V, H)
    xn = np.array(XN, np.int32)

    def jstep(m, st, chunk, xn):
        return jax_step(m, params, st, jnp.asarray(chunk.numpy()), xn=xn)

    want = _stream_all(model, torch.tensor(feats), 7, xn=xn, beam=beam,
                       step=jstep,
                       init=lambda m, n, **kw: jax_init(m, params, n, **kw),
                       finish=lambda m, st, xn: jax_finish(m, params, st,
                                                           xn=xn))
    got = _stream_all(port, torch.tensor(feats), 7, xn=torch.tensor(xn),
                      beam=beam)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if beam:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-4)
