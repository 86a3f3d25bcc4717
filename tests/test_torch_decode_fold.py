"""The device loop's mask and count folded into the decode step's kernels
(`utils/device_loop.py` ``folded=True``, `ops/decode_step.py`
`decode_gru_greedy` and `decode_beam_select` given the loop's count), on
the CPU, where the wrappers run their plain versions: JAX's ``cond``,
``where`` and count after the step, as the unfolded loop applied them.

  * A masked step changes nothing: with every sample past its frame bound,
    the folded greedy GRU returns the whole state (``emitted_here`` and
    ``last_tok`` too, which the unfolded step rewrites) and the count bit
    for bit; the folded selection returns beam's seven fields, ``emit``
    all 0 and ``src`` the identity, and the GRU after it every row.
  * The folded drains (`greedy_drain`, `beam_drain` at beam 1 and 4, which
    fold on `ops.decode_step`) against JAX's on the same encoder frames,
    fp32 and bf16 models, at unroll 1, 3, 16 and 64: the whole state,
    integers exact, floats within `test_torch_device_loop.py`'s
    tolerance; the trip count equal to JAX's ``lax.while_loop``'s and the
    host reads max(1, ceil(trips / unroll)); ten surplus steps leave
    every field bit for bit; folded equals unfolded (the loop's own mask,
    `decode_step_cases.UNFOLDED`) bit for bit.
  * A chunked streaming session equals the one-shot decode at unroll 3,
    folded, greedy and beam.
  * A folded and an unfolded drain of one shape never share a graph
    cache key (`device_loop.cache_key`, read on the CPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from test_torch_device_loop import _assert_state_matches
from warp_rnnt_tpu.models import beam_search as jax_beam_search
from warp_rnnt_tpu.models import decoding as jax_decoding
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    init_model,
    stream_finish,
    stream_init,
    stream_step,
)
from warp_rnnt_tpu_torch.models import beam_search, decoding
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop

N, T, F, V, H, ML = 4, 19, 9, 13, 32, 12
XN = np.array([19, 14, 6, 1], np.int32)
BEAMS = (1, 4)
UNROLLS = (1, 3, 16, 64)


def _bits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# ---- a masked step, on the wrappers ----

def _greedy_args(seed):
    """`decode_gru_greedy`'s arguments at `decode_step_cases.ODD`'s
    widths, every sample past its frame bound, emitted_here nonzero."""
    *_, greedy = dsc.odd_args(seed, 5, 5, None, torch.float32, device="cpu")
    best, t, u, eh, fb, tokens, *rest = greedy
    g = torch.Generator().manual_seed(seed)
    fb = t - torch.randint(0, 3, t.shape, generator=g, dtype=torch.int32)
    eh = torch.randint(1, 4, t.shape, generator=g, dtype=torch.int32)
    return (best, t, u, eh, fb, tokens, *rest)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_greedy_step_keeps_the_whole_state(seed):
    args = _greedy_args(seed)
    best, t, u, eh, fb, tokens, h, out = args[:8]
    last_tok = (best + 1) % V
    count = torch.tensor(7, dtype=torch.int32)
    got = ds.decode_gru_greedy(*args, last_tok, count)
    _bits_equal(got, (t, u, eh, tokens, h, out, last_tok, count))
    # the teeth: the unfolded step rewrites emitted_here and last_tok
    unfolded = ds.decode_gru_greedy(*args)
    assert not torch.equal(unfolded[2], eh)
    assert not torch.equal(best, last_tok)


@pytest.mark.parametrize("B", dsc.SELECT_BEAMS)
def test_masked_beam_step_keeps_the_whole_state(B):
    args = list(dsc.select_state(10 + B, B, device="cpu"))
    t = args[0]
    args[10] = t - (t % 2)  # every sample at or past its frame bound
    count = torch.tensor(3, dtype=torch.int32)
    got = ds.decode_beam_select(*args, count)
    _bits_equal(got[:7], tuple(args[:7]))
    assert not got[7].any()
    rows = got[9].numel()
    assert torch.equal(got[9], torch.arange(rows, dtype=torch.int32))
    assert torch.equal(got[10], count)
    # the GRU after it copies every row
    *_, gru, _ = dsc.odd_args(B, rows, rows // B, None, torch.float32,
                              device="cpu")
    _, h, out, _, *params = gru
    h_new, out_new = ds.decode_gru(got[8], h, out, got[7], *params,
                                   src=got[9])
    _bits_equal((h_new, out_new), (h, out))
    # the teeth: unfolded, the selection re-sorts and settles the beams
    unfolded = ds.decode_beam_select(*args)
    assert not all(torch.equal(a, b) for a, b in zip(unfolded[:7], args[:7]))


@pytest.mark.parametrize("go", [True, False])
def test_folded_plain_versions_equal_the_loops_mask(go):
    """The folded plain versions are the unfolded step and then the loop's
    ``where`` and count, field by field."""
    args = list(_greedy_args(4))
    t, fb = args[1], args[4]
    if go:
        args[4] = fb.clone()
        args[4][2] = t[2] + 1
    last_tok = args[0].flip(0)
    count = torch.tensor(2, dtype=torch.int32)
    cond = bool((args[1] < args[4]).any())
    assert cond == go
    new = ds.decode_gru_greedy_plain(*args)
    want = (*new, args[0]) if go else (*args[1:4], args[5], *args[6:8],
                                       last_tok)
    _bits_equal(ds.decode_gru_greedy_plain(*args, last_tok, count),
                (*want, count + int(go)))


# ---- the folded drains against JAX ----

@pytest.fixture(scope="module", params=["fp32", "bf16"])
def drains(request):
    """(port model, JAX's encoder frames as a torch tensor, {decoder:
    (JAX's final state, JAX's trip count)}) for greedy and beam 1 and 4;
    the trip counts read through a counting ``lax.while_loop``."""
    feats = np.random.RandomState(3).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair(request.param, 4, feats, V, H)
    bound = model.bind(params)
    enc = bound.encode(jnp.asarray(feats))
    trips = []
    plain_while = jax.lax.while_loop

    def counted(cond, body, init):
        out, n = plain_while(lambda s: cond(s[0]),
                             lambda s: (body(s[0]), s[1] + 1), (init, 0))
        trips.append(int(n))
        return out

    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", counted)
        want["greedy"] = (jax_decoding.greedy_drain(
            bound, jax_decoding.greedy_state_init(bound, N, ML), enc, 0, XN),
            trips[-1])
        for B in BEAMS:
            want[f"beam{B}"] = (jax_beam_search.beam_drain(
                bound, jax_beam_search.beam_state_init(bound, N, B, ML), enc,
                0, XN), trips[-1])
    return port, torch.tensor(np.asarray(enc)), want


def _drain(port, enc, name, state=None, ops=ds):
    if name == "greedy":
        state = state or decoding.greedy_state_init(port, N, ML)
        return decoding.greedy_drain(port, state, enc, 0, torch.tensor(XN),
                                     ops=ops)
    B = int(name[4:])
    state = state or beam_search.beam_state_init(port, N, B, ML)
    return beam_search.beam_drain(port, state, enc, 0, torch.tensor(XN),
                                  ops=ops)


def _counter(name):
    return "greedy" if name == "greedy" else "beam"


@pytest.fixture
def loops(monkeypatch):
    """The device loop calls of the drains: [(key, folded, state,
    consts)]."""
    calls = []
    plain = decoding.while_loop

    def spy(cond, body, state, consts=(), **kw):
        calls.append((kw["key"], kw.get("folded", False), tuple(state),
                      tuple(consts)))
        return plain(cond, body, state, consts, **kw)

    monkeypatch.setattr(decoding, "while_loop", spy)
    return calls


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("name", ["greedy", *(f"beam{B}" for B in BEAMS)])
def test_folded_drain_matches_jax(drains, loops, name, unroll):
    port, enc, want = drains
    state, trips = want[name]
    c = _counter(name)
    decoding.LOOP_ITERATIONS[c] = decoding.HOST_READS[c] = 0
    with device_loop.unrolled(unroll):
        got = _drain(port, enc, name)
    assert [folded for _, folded, _, _ in loops] == [True]
    _assert_state_matches(got, state)
    assert decoding.LOOP_ITERATIONS[c] == trips
    assert decoding.HOST_READS[c] == max(1, math.ceil(trips / unroll))
    with device_loop.unrolled(unroll):
        unfolded = _drain(port, enc, name, ops=dsc.UNFOLDED)
    assert [folded for _, folded, _, _ in loops] == [True, False]
    _bits_equal(got, unfolded)


@pytest.mark.parametrize("name", ["greedy", *(f"beam{B}" for B in BEAMS)])
def test_ten_surplus_folded_steps_leave_the_state(drains, name):
    port, enc, want = drains
    done = _drain(port, enc, name)
    c = _counter(name)
    decoding.LOOP_ITERATIONS[c] = decoding.HOST_READS[c] = 0
    with device_loop.unrolled(10):
        again = _drain(port, enc, name, done)
    assert decoding.LOOP_ITERATIONS[c] == 0
    assert decoding.HOST_READS[c] == 1
    _bits_equal(again, done)
    _assert_state_matches(again, want[name][0])


def test_streaming_chunked_equals_one_shot_folded(loops):
    S_N, S_T, S_ML = 3, 37, 24
    model, _, _ = init_model(1, vocab_size=V, feat_dim=F, N=S_N, T=S_T,
                             U=5, device="cpu", encoder_hidden=H,
                             predictor_hidden=H, joint_hidden=H)
    feats = torch.tensor(np.random.RandomState(7).randn(S_N, S_T, F)
                         .astype(np.float32))
    xn = torch.tensor([37, 22, 9], dtype=torch.int32)
    with device_loop.unrolled(3):
        for beam in (0, 4):
            if beam:
                want = beam_decode(model, feats, xn, S_ML, beam_size=beam)
            else:
                want = greedy_decode(model, feats, xn, S_ML)
            st = stream_init(model, S_N, S_ML, beam_size=beam)
            for i in range(0, S_T, 7):
                st = stream_step(model, st, feats[:, i:i + 7], xn=xn)
            _bits_equal(stream_finish(model, st, xn=xn)[:-1], want)
    assert loops and all(folded for _, folded, _, _ in loops)


@pytest.mark.parametrize("name", ["greedy", "beam4"])
def test_folded_and_unfolded_drains_never_share_a_graph(drains, loops, name):
    port, enc, _ = drains
    _drain(port, enc, name)
    _drain(port, enc, name, ops=dsc.UNFOLDED)
    (k1, f1, s1, c1), (k2, f2, s2, c2) = loops
    assert (f1, f2) == (True, False)
    keys = [device_loop.cache_key(k, device_loop.UNROLL, "cuda:0", s, c, f)
            for k, f, s, c in ((k1, f1, s1, c1), (k2, f2, s2, c2))]
    assert keys[0] != keys[1]
    # the drain's own key names the fold (`run_drain`: name, model,
    # parameters, fold, ...); so does the loop's, whatever key a caller
    # passes
    assert k1[3] is True and k2[3] is False
    assert (device_loop.cache_key(k1, 16, "cuda:0", s1, c1, True)
            != device_loop.cache_key(k1, 16, "cuda:0", s1, c1, False))
    # the same drain twice keys the same graph
    _drain(port, enc, name)
    assert loops[2][0] == k1 and device_loop.cache_key(
        loops[2][0], device_loop.UNROLL, "cuda:0", loops[2][2], loops[2][3],
        loops[2][1]) == keys[0]


def test_folds_only_on_the_kernel_module():
    assert decoding.folds(ds)
    for ops in (ds.PLAIN, dsc.UNFOLDED, dsc.BASELINE, dsc.PARENT,
                dsc.Recorder()):
        assert not decoding.folds(ops)
    with ds.using(dsc.BASELINE_SOURCE):  # the first kernels fold nothing
        assert not decoding.folds(ds)
    assert decoding.folds(ds)


# ---- the card checks' code on the CPU (both sides the plain version) ----

def test_fold_card_checks_run_on_the_cpu():
    from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc

    d = dict(sc.SMALL, beam=3)
    model = sc.carried_model(d, 1, "cpu", torch.float32)
    feats = sc.features(2, d["N"], d["T"], d["F"], "cpu")
    xn = sc.ragged(d["N"], d["T"], "cpu")
    recs, _ = dsc.record_states(model, feats, xn, d["max_length"], d["beam"],
                                every=4)
    out = dsc.check_fold_records(recs)
    assert set(out) == {"greedy", "beam"}
    assert out["greedy"]["decode_gru_greedy"]["calls"] >= 2
    assert out["beam"]["decode_beam_select"]["calls"] >= 2
    assert all(r["max_abs_err"] == 0.0 for v in out.values()
               for r in v.values())
    odd = dsc.odd_cases(device="cpu")
    folded = [r for c in odd.values() for k, r in c.items() if "folded" in k]
    assert len(folded) == 2 * 2 * 2 * sum(k is None for *_, k in dsc.ODD_ROWS)
    assert all(r["max_abs_err"] == 0.0 for r in folded)
    sel = dsc.select_fold_cases(device="cpu")
    assert len(sel) == 2 * len(dsc.SELECT_BEAMS)
    assert all(r["max_abs_err"] == 0.0 for r in sel.values())
    drains = dsc.check_fold(model, feats, xn, d["max_length"], d["beam"], 7)
    assert len(drains) == 4
    assert all(r["iterations"] > 0 for r in drains.values())
