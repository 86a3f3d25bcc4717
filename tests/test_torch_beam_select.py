"""The beam-search step as three calls (`warp_rnnt_tpu_torch/models/
beam_search.py`): `decode_joint`, `decode_beam_select` (the candidates'
top-k, the beams' gathers, the token write, the hash, the merge and the
frame advance) and `decode_gru` with a row map, on the CPU, where the
wrappers run their plain versions (`ops/decode_step.py`).

  * Against JAX's `beam_decode` on a carried fp32 model: tokens and
    lengths equal, scores within `test_torch_decoding.py`'s SCORE_ATOL,
    at B = 1, 2, 4, 8, max_symbols_per_step 1 and 4, blank 0 and V - 1;
    JAX's `beam_drain` on the whole state (JAX's encoder frames fed to
    both); a chunked streaming beam session equal to the one-shot decode
    bit for bit.
  * `decode_beam_select_plain` then `decode_gru_plain(src=...)` against
    the body as it ran before them (kept here), bit for bit on every
    state field, on hand-built adversarial states
    (`decode_step_cases.select_state`: ties, duplicates that merge, beams
    at the emission cap and at u = L, samples past their frame bound,
    all-NEG samples, fewer live candidates than beams).
  * `decode_gru_plain` with ``src`` equal to a gather, then the GRU.
  * The wrapper on CPU tensors runs the plain version, and the card
    checks' code (`select_cases`, `check_select_records`,
    `check_parent_path`) runs on the CPU, both sides plain.
The kernel on the card: `tests/test_torch_decode_step_card.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import beam_decode as jax_beam
from warp_rnnt_tpu.models import beam_search as jax_beam_search
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models import beam_decode, beam_search
from warp_rnnt_tpu_torch.models.streaming import (
    stream_finish,
    stream_init,
    stream_step,
)
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.ops.decode_step import NEG

N, T, F, V, H, ML = 4, 23, 9, 21, 24, 12
XN = np.array([23, 19, 11, 4], np.int32)
SCORE_ATOL = 1e-4  # test_torch_decoding.py's


@pytest.fixture(scope="module")
def setup():
    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair("fp32", 2, feats, V, H)
    return model, params, port, feats


# ---- the new body against JAX ----

@pytest.mark.parametrize("blank", [0, V - 1], ids=["blank0", "blankV-1"])
@pytest.mark.parametrize("max_symbols", [1, 4])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_beam_matches_jax(setup, B, max_symbols, blank):
    model, params, port, feats = setup
    tok, ln, sc_ = beam_decode(port, torch.tensor(feats), torch.tensor(XN),
                               ML, beam_size=B,
                               max_symbols_per_step=max_symbols, blank=blank)
    want = [np.asarray(x) for x in jax_beam(
        model, params, jnp.asarray(feats), XN, ML, beam_size=B,
        max_symbols_per_step=max_symbols, blank=blank)]
    np.testing.assert_array_equal(ln.numpy(), want[1])
    np.testing.assert_array_equal(tok.numpy(), want[0])
    np.testing.assert_allclose(sc_.numpy(), want[2], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("B", [2, 8])
def test_beam_drain_matches_jax_on_the_whole_state(setup, B):
    model, params, port, feats = setup
    bound = model.bind(params)
    enc = bound.encode(jnp.asarray(feats))
    want = jax_beam_search.beam_drain(
        bound, jax_beam_search.beam_state_init(bound, N, B, ML), enc, 0, XN,
        max_symbols_per_step=2)
    got = beam_search.beam_drain(
        port, beam_search.beam_state_init(port, N, B, ML),
        torch.tensor(np.asarray(enc)), 0, torch.tensor(XN),
        max_symbols_per_step=2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=SCORE_ATOL)
        else:  # JAX's hash is uint32, the port's int64 in [0, 2^32)
            np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                          w.astype(np.int64))


@pytest.mark.parametrize("C", [1, 6])
def test_streaming_beam_session_equals_one_shot(setup, C):
    _, _, port, feats = setup
    x, xn = torch.tensor(feats), torch.tensor(XN)
    want = beam_decode(port, x, xn, ML, beam_size=4)
    st = stream_init(port, N, ML, beam_size=4)
    for i in range(0, T, C):
        st = stream_step(port, st, x[:, i:i + C], xn=xn)
    got = stream_finish(port, st, xn=xn)[:3]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- the body as it ran before decode_beam_select ----

def _before(state, lp_blank, top_lp, top_ids, frame_bound, max_symbols,
            gru):
    """The beam body's lines after the joint, as they ran before the
    selection was one call, with the GRU as `decode_gru_plain`."""
    (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
     pred_out) = state
    N_, B_, L = tokens.shape
    K = top_lp.shape[1]
    l_iota = torch.arange(L)[None, None, :]
    i_iota = torch.arange(B_)[None, :, None]
    j_iota = torch.arange(B_)[None, None, :]
    frame_on = (t < frame_bound)[:, None]
    lp_blank = lp_blank.reshape(N_, B_)
    top_lp, top_ids = top_lp.reshape(N_, B_, K), top_ids.reshape(N_, B_, K)
    alive = scores > 0.5 * NEG
    expandable = (frame_on & alive & ~waiting & (u < L)
                  & (nexp < max_symbols))
    settle = torch.where(frame_on & ~waiting, scores + lp_blank, scores)
    lab_scores = torch.where(expandable[..., None],
                             scores[..., None] + top_lp, NEG)
    cand = torch.cat([settle[..., None], lab_scores], -1)
    new_scores, sel = beam_search._top_k_small(
        cand.reshape(N_, B_ * (K + 1)), B_)
    parent = sel // (K + 1)
    kind = sel % (K + 1)
    gather = beam_search._gather_beams
    tokens = gather(tokens, parent)
    u = gather(u, parent)
    nexp = gather(nexp, parent)
    hcode = gather(hcode, parent)
    pred_state = gather(pred_state, parent)
    pred_out = gather(pred_out, parent)
    scores = new_scores
    emit = kind > 0
    new_tok = gather(top_ids, parent).gather(
        2, (kind - 1).clamp(min=0).long()[..., None])[..., 0]
    tokens = torch.where(emit[..., None] & (l_iota == u[..., None]),
                         new_tok[..., None], tokens)
    pred_state, pred_out = ds.decode_gru_plain(
        new_tok.reshape(-1), pred_state.reshape(N_ * B_, -1),
        pred_out.reshape(N_ * B_, -1), emit.reshape(-1), *gru)
    pred_state = pred_state.reshape(N_, B_, -1)
    pred_out = pred_out.reshape(N_, B_, -1)
    u = torch.where(emit, u + 1, u)
    nexp = torch.where(emit, nexp + 1, nexp)
    hcode = torch.where(emit, beam_search._hash_step(hcode, new_tok), hcode)
    waiting = frame_on & ~emit
    same = ((hcode[:, :, None] == hcode[:, None, :])
            & (u[:, :, None] == u[:, None, :])
            & (waiting[:, :, None] == waiting[:, None, :]))
    s_i = scores[:, :, None]
    s_j = scores[:, None, :]
    beats = (s_i > s_j) | ((s_i == s_j) & (i_iota < j_iota))
    killed = (same & beats & (i_iota != j_iota)).any(dim=1)
    scores = torch.where(killed, NEG, scores)
    active = ~waiting & (scores > 0.5 * NEG)
    advance = (t < frame_bound) & ~active.any(dim=1)
    t = torch.where(advance, t + 1, t)
    waiting = waiting & ~advance[:, None]
    nexp = torch.where(advance[:, None], 0, nexp)
    return (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
            pred_out)


def _gru(seed, vocab, Hp=16):
    rng = np.random.RandomState(seed)

    def normal(*shape, scale=0.3):
        return torch.tensor((scale * rng.randn(*shape)).astype(np.float32))

    return (normal(vocab, Hp), normal(3 * Hp, Hp), normal(3 * Hp, Hp),
            normal(3 * Hp), torch.cat([torch.zeros(2 * Hp), normal(Hp)]))


@pytest.mark.parametrize("max_symbols", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_select_then_gru_equals_the_body_before(B, max_symbols):
    args = dsc.select_state(10 + B, B, "cpu")[:-1] + (max_symbols,)
    t, scores, tokens, u, nexp, waiting, hcode = args[:7]
    lp_blank, top_lp, top_ids, frame_bound = args[7:11]
    n_, Hp = t.shape[0], 16
    rng = np.random.RandomState(B)
    pred_state = torch.tensor(rng.randn(n_, B, Hp).astype(np.float32))
    pred_out = torch.tensor(rng.randn(n_, B, Hp).astype(np.float32))
    gru = _gru(B, dsc.ODD["V"], Hp)
    want = _before((*args[:7], pred_state, pred_out), lp_blank, top_lp,
                   top_ids, frame_bound, max_symbols, gru)
    (*new, emit, new_tok, src) = ds.decode_beam_select_plain(*args)
    h, out = ds.decode_gru_plain(new_tok, pred_state.reshape(n_ * B, Hp),
                                 pred_out.reshape(n_ * B, Hp), emit, *gru,
                                 src=src)
    got = (*new, h.reshape(n_, B, Hp), out.reshape(n_, B, Hp))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the states reach what they were built for
    kind = dict(zip(dsc.SELECT_SAMPLES, range(n_)))
    assert int(got[0][kind["past_bound"]]) == int(t[kind["past_bound"]])
    assert (got[1][kind["all_neg"]] == NEG).all()
    emits = emit.reshape(n_, B)
    assert not emits[kind["dup_blank"]].any() and emits[kind["dup_emit"]].all()
    for name in ("dup_blank", "dup_emit"):  # one survives the merge
        assert int((got[1][kind[name]] > NEG).sum()) == 1
    assert emit.dtype == torch.bool and src.dtype == torch.int32
    assert (src.reshape(n_, B) // B
            == torch.arange(n_, dtype=torch.int32)[:, None]).all()


def test_gru_row_map_equals_a_gather_then_the_gru():
    rows, Hp = 12, 16
    rng = np.random.RandomState(3)
    gru = _gru(4, 29, Hp)
    token = torch.tensor(rng.randint(-1, 29, rows).astype(np.int32))
    h = torch.tensor(rng.randn(rows, Hp).astype(np.float32))
    out = torch.tensor(rng.randn(rows, Hp).astype(np.float32))
    emit = torch.tensor(rng.randint(0, 2, rows).astype(bool))
    src = torch.tensor(rng.randint(0, rows, rows).astype(np.int32))
    want = ds.decode_gru_plain(token, h[src.long()], out[src.long()], emit,
                               *gru)
    for got in (ds.decode_gru_plain(token, h, out, emit, *gru, src=src),
                ds.decode_gru(token, h, out, emit, *gru, src=src)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # without a row map, as before
    plain = ds.decode_gru_plain(token, h, out, emit, *gru)
    assert torch.equal(plain[0][~emit], h[~emit])


# ---- the wrapper and the card checks' code on the CPU ----

def test_select_wrapper_on_cpu_runs_the_plain_version():
    args = dsc.select_state(7, 4, "cpu")
    before = dict(ds.LAUNCHES)
    got = ds.decode_beam_select(*args)
    want = ds.decode_beam_select_plain(*args)
    assert ds.LAUNCHES == before
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    assert ds.PLAIN.decode_beam_select is ds.decode_beam_select_plain
    # the kernel's limits, checked before a launch
    ins = args[:-1]
    with pytest.raises(ValueError, match="beam width"):
        ds._select_check(*ins[:2], ins[2].repeat_interleave(17, 1), *ins[3:])
    with pytest.raises(ValueError, match="hcode"):
        ds._select_check(*ins[:6], ins[6].int(), *ins[7:])


def test_select_cases_run_on_the_cpu():
    out = dsc.select_cases(device="cpu")
    assert set(out) == {f"B={B}" for B in dsc.SELECT_BEAMS}
    assert all(r["max_abs_err"] == 0.0 for r in out.values())
    assert sum(r["emitting"] for r in out.values()) > 0
    assert sum(r["advanced"] for r in out.values()) > 0


def test_recorded_selections_and_parent_path_on_the_cpu():
    d = dict(sc.SMALL, beam=4)
    model = sc.carried_model(d, 1, "cpu", torch.float32)
    feats = sc.features(2, d["N"], d["T"], d["F"], "cpu")
    xn = sc.ragged(d["N"], d["T"], "cpu")
    recs, _ = dsc.record_states(model, feats, xn, d["max_length"],
                                d["beam"], every=4)
    out = dsc.check_select_records(recs)
    assert set(out) == {"beam"} and out["beam"]["calls"] >= 2
    # the recorded GRU calls carry the row map
    assert all(len(a) == 10 for a in recs["beam"].calls["decode_gru"][1:])
    lengths = dsc.check_parent_path(model, feats, xn, d["max_length"],
                                    d["beam"], 7)
    assert lengths["decode"] == lengths["session"]


def test_step_kernels_leave_out_only_the_rounds_own_tail():
    from warp_rnnt_tpu_torch.benchmarks import bench_decode as bd

    U = 16
    # a replay of one round: the step's kernels, the round's status stack
    rows = [(0.1, 3 * U, "decode_joint_rows_kernel"),
            (0.1, U, "decode_beam_select_kernel"),
            (0.1, U, "decode_gru_kernel"),
            (0.1, 1, "CatArrayBatchedCopy<int, 2>"),
            (0.1, 2 * U, "elementwise_kernel<where>")]
    ours, left = bd.step_kernels(rows, U)
    assert ours == {"decode_joint_rows_kernel": 3.0,
                    "decode_beam_select_kernel": 1.0,
                    "decode_gru_kernel": 1.0}
    assert left == []
    # a cat a step beside the tail, under one name or another
    for extra in ([(0.1, U + 1, "CatArrayBatchedCopy<int, 2>")],
                  [(0.1, 1, "CatArrayBatchedCopy<int, 2>"),
                   (0.1, U, "CatArrayBatchedCopy_contig<float, 3>")]):
        assert bd.step_kernels(rows[:3] + extra, U)[1]
    # the tail exempts a cat only: one gather a round is still listed
    assert bd.step_kernels(rows + [(0.1, 1, "gather_kernel")], U)[1] == [
        "gather_kernel"]
