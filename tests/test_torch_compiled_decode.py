"""A whole decode and a whole streaming chunk compiled through
`utils.compiled_step` (the port's ``jax.jit`` over JAX's jitted
`greedy_decode`, `beam_decode`, `stream_step` and `stream_finish`), on the
CPU, where a compiled step runs its function eagerly: the plain version.

  * `decoding.compiled_greedy_decode` and `beam_search.compiled_beam_decode`
    against JAX's jitted decoders on a carried fp32 tree
    (`_torch_port_helpers.carried_pair`): tokens and lengths equal, beam
    scores within 1e-4 absolute (`tests/test_torch_streaming.py`'s
    tolerance); each call counts one trip count and its host reads.
  * A streaming session (greedy and beam 3, chunks of 4 and a ragged tail
    of 3, ``xn`` given) against JAX's jitted `stream_step` /
    `stream_finish`.
  * The compiled decoders' keys change with a parameter's address,
    ``max_length``, the loop's unroll and the features' shape;
    `compiled_step.module_key` with a parameter replaced (assigned, or
    written into ``_parameters``) or moved.
  * The session's flat buffer (`streaming.pack` / `unpack`) round trips
    every dtype of a state, and a state of its views is passed as its
    buffer (`streaming._buffer`), any other state is packed; the eager
    session packs nothing.
  * `device_loop.while_loop`'s ``on_read`` receives each eager loop's
    stats once.
The card's checks (compiled against eager and `device_loop._plain()` bit
for bit, one replay and one host read a call, one conditional node, the
bound error after a replay, interleaved sessions, in-place weight
updates, held loops) are in `tests/test_torch_compiled_decode_card.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import beam_decode as jax_beam
from warp_rnnt_tpu.models import greedy_decode as jax_greedy
from warp_rnnt_tpu.models import stream_finish as jax_finish
from warp_rnnt_tpu.models import stream_init as jax_init
from warp_rnnt_tpu.models import stream_step as jax_step
from warp_rnnt_tpu_torch.models import (
    beam_search,
    decoding,
    init_model,
    stream_finish,
    stream_init,
    stream_step,
    streaming,
)
from warp_rnnt_tpu_torch.utils import compiled_step as cs
from warp_rnnt_tpu_torch.utils import device_loop as dl

N, T, F, V, H, ML, C = 3, 15, 9, 21, 24, 10, 4  # chunks of 4, a tail of 3
XN = np.array([15, 11, 6], np.int32)
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    feats = np.random.RandomState(3).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair("fp32", 4, feats, V, H)
    return model, params, port, feats


@pytest.fixture(scope="module")
def small():
    return init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=5,
                      device="cpu", encoder_hidden=H, predictor_hidden=H,
                      joint_hidden=H)[0]


def test_compiled_greedy_matches_jax_jit(pair):
    model, params, port, feats = pair
    want = jax.jit(lambda f, n: jax_greedy(model, params, f, n, ML))(
        jnp.asarray(feats), XN)
    decoding.LOOP_ITERATIONS["greedy"] = decoding.HOST_READS["greedy"] = 0
    tok, ln = decoding.compiled_greedy_decode(port, torch.tensor(feats),
                                              torch.tensor(XN), ML)
    np.testing.assert_array_equal(ln.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want[0]))
    it = decoding.LOOP_ITERATIONS["greedy"]
    reads = decoding.HOST_READS["greedy"]
    assert int(XN.max()) <= it <= int(XN.max()) + ML and reads >= 1


@pytest.mark.parametrize("B", [1, 3])
def test_compiled_beam_matches_jax_jit(pair, B):
    model, params, port, feats = pair
    want = jax.jit(lambda f, n: jax_beam(model, params, f, n, ML,
                                         beam_size=B))(jnp.asarray(feats), XN)
    tok, ln, sc = beam_search.compiled_beam_decode(
        port, torch.tensor(feats), XN, ML, beam_size=B)
    np.testing.assert_array_equal(ln.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want[2]), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("beam", [0, 3])
def test_compiled_session_matches_jax_jit(pair, beam):
    model, params, port, feats = pair
    jstep = jax.jit(lambda st, chunk, xn: jax_step(model, params, st, chunk,
                                                   xn=xn))
    jfinish = jax.jit(lambda st, xn: jax_finish(model, params, st, xn=xn))
    jst = jax_init(model, params, N, max_length=ML, beam_size=beam)
    for i in range(0, T, C):
        jst = jstep(jst, jnp.asarray(feats[:, i:i + C]), XN)
    want = jfinish(jst, XN)
    x, xn = torch.tensor(feats), torch.tensor(XN)
    st = stream_init(port, N, ML, beam_size=beam)
    for i in range(0, T, C):
        st = stream_step(port, st, x[:, i:i + C], xn=xn)
    got = stream_finish(port, st, xn=xn)
    assert streaming.LAST_GRAPH == {"step": None, "finish": None}  # eager
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if beam:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=SCORE_ATOL)


def _cache_key(model, beam=False, max_length=ML, t=T):
    feats, xn = torch.zeros(N, t, F), torch.zeros(N, dtype=torch.int32)
    step = (beam_search.compiled_beam(model, max_length, 3) if beam
            else decoding.compiled_greedy(model, max_length))
    with torch.inference_mode():
        return step._cache_key((feats, xn))


@pytest.mark.parametrize("beam", [False, True])
def test_compiled_decode_key(small, beam):
    base = _cache_key(small, beam)
    assert _cache_key(small, beam) == base
    others = [_cache_key(small, beam, max_length=ML + 1),
              _cache_key(small, beam, t=T + 1),
              _cache_key(small, not beam)]
    with dl.unrolled(dl.UNROLL + 1):
        others.append(_cache_key(small, beam))
    w = small.joint.out.weight
    saved = w.data
    try:  # one parameter at a new address, the same values
        w.data = saved.clone()
        others.append(_cache_key(small, beam))
    finally:
        w.data = saved
    assert _cache_key(small, beam) == base
    assert len(set(others)) == len(others) and base not in others


def test_module_key_sees_a_replaced_parameter(small):
    key = cs.module_key(small)
    assert cs.module_key(small) == key
    saved = small.predictor.bias_hn
    try:
        small.predictor.bias_hn = torch.nn.Parameter(saved.detach().clone())
        assert cs.module_key(small) != key
    finally:
        small.predictor.bias_hn = saved
    assert cs.module_key(small) == key
    params = small.joint.out._parameters  # no registration hook runs
    saved = params["weight"]
    try:
        params["weight"] = torch.nn.Parameter(saved.detach().clone())
        assert cs.module_key(small) != key
    finally:
        params["weight"] = saved
    assert cs.module_key(small) == key


def test_pack_round_trips_every_dtype():
    gen = torch.Generator().manual_seed(0)
    xs = (torch.tensor(7, dtype=torch.int32),
          torch.randn(2, 3, 5, generator=gen).to(torch.bfloat16),
          torch.randint(0, 2 ** 40, (3, 2), generator=gen),
          torch.rand(3, 4, generator=gen) > 0.5,
          torch.randn(4, 3, generator=gen)[:, 1],  # not contiguous
          torch.randint(-9, 9, (5,), generator=gen, dtype=torch.int32))
    spec = streaming._spec(xs)
    buf = streaming.pack(xs)
    offsets, end = streaming._layout(spec)
    assert buf.dtype == torch.uint8 and buf.numel() == end
    assert all(o % streaming._ALIGN == 0 for o in offsets)
    back = streaming.unpack(buf, spec)
    assert all(b.dtype == x.dtype and torch.equal(b, x)
               for b, x in zip(back, xs))
    same = streaming._buffer(back, spec)  # the views' own storage
    assert same.data_ptr() == buf.data_ptr() and same.numel() == end
    again = streaming._buffer(xs, spec)
    assert again.data_ptr() != buf.data_ptr() and torch.equal(again, buf)


def test_a_session_state_is_its_buffer(small):
    st = stream_init(small, N, ML, beam_size=3)
    leaves = streaming._leaves(st)
    spec = streaming._spec(leaves)
    buf = streaming._buffer(leaves, spec)  # a fresh state: packed
    assert all(t.untyped_storage().data_ptr() != buf.data_ptr()
               for t in leaves)
    views = streaming._session(streaming.unpack(buf, spec), True)
    assert streaming._buffer(streaming._leaves(views),
                             spec).data_ptr() == buf.data_ptr()
    part = {"enc": views["enc"], "dec_beam": (
        views["dec_beam"][0].clone(), *views["dec_beam"][1:])}
    assert streaming._buffer(streaming._leaves(part),
                             spec).data_ptr() != buf.data_ptr()
    new = stream_step(small, views, torch.zeros(N, C, F))
    assert type(new) is dict  # the eager chunk packs nothing
    assert all(t.untyped_storage().data_ptr() != buf.data_ptr()
               for t in streaming._leaves(new))


def test_on_read_gets_each_loop_once():
    seen = []
    lim = torch.tensor([0, 3, 5], dtype=torch.int32)
    state = (torch.zeros(3, dtype=torch.int32),)
    out, stats = dl.while_loop(
        lambda s, c: (s[0] < c[0]).any(),
        lambda s, c: (torch.where(s[0] < c[0], s[0] + 1, s[0]),), state,
        (lim,), max_iterations=5, key="on_read", on_read=seen.append)
    assert seen == [stats] and stats.iterations == 5
    assert torch.equal(out[0], lim)
