"""The decode step's invariants and kernels (`models/decoding.py`
`decode_consts`, `warp_rnnt_tpu_torch/ops/decode_step.py`), on the CPU,
where the kernels' wrappers run their plain versions.

  * The lifted step equals the step as the decoders ran it before (the
    joint casting its weights and the predictor building its recurrent
    bias every step), bit for bit: whole greedy and beam drains on the
    whole state, "add" and "concat" joints, bf16 and fp32.
  * `decode_joint`'s plain version against JAX's `Transducer.joint_step`
    on a carried tree: fp32 log-probs within 1e-5 and argmax ids equal;
    bf16 within `decode_step_cases.logp_tol` (4 bf16 ulps of the largest
    logit: the frameworks' fp32 tanh differ in the last bit now and then,
    which flips a bf16 rounding of h), ids equal where JAX's margin
    exceeds twice that.  Its beam epilogue against JAX's `_top_k_small`
    with the blank at NEG.
  * `epilogue_plain` against JAX's `_top_k_small` on ties, -inf rows,
    V <= K + 1, and the blank at 0 and at V - 1.
  * `decode_gru`'s plain version, with its mask, against
    `Predictor.step` and the decoders' ``torch.where``s bit for bit, and
    against JAX's `predictor_step` within 1e-5; `decode_gru_greedy`'s
    against greedy's masked update bit for bit.
  * The card checks of `benchmarks/decode_step_cases.py` run on the CPU,
    where both sides are the plain version: every error 0.
The kernels on the card: `tests/test_torch_decode_step_card.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models.beam_search import NEG as JAX_NEG
from warp_rnnt_tpu.models.beam_search import _top_k_small as jax_top_k
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models import beam_search, decoding, init_model
from warp_rnnt_tpu_torch.models.beam_search import (
    _gather_beams,
    _hash_step,
    _top_k_small,
)
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.ops.decode_step import NEG
from warp_rnnt_tpu_torch.utils import device_loop

N, T, F, V, H, ML, B = 4, 23, 9, 21, 24, 12, 3
XN = np.array([23, 19, 11, 4], np.int32)


# ---- the step as the decoders ran it before the invariants were lifted ----

def _old_greedy(model, dec, enc, p0, frame_bound, max_symbols=4, blank=0):
    C = enc.shape[1]
    max_length = dec[6].shape[1]

    def body(state, consts):
        enc, frame_bound, p0 = consts
        t, u, emitted_here, last_tok, pred_state, pred_out, tokens = state
        l_iota = torch.arange(max_length, device=enc.device)[None, :]
        active = t < frame_bound
        logp = model.joint_step(decoding.frame_at(enc, t, p0), pred_out)
        best = logp.argmax(dim=-1).to(torch.int32)
        emit = (active & (best != blank) & (u < max_length)
                & (emitted_here < max_symbols))
        tokens = torch.where(emit[:, None] & (l_iota == u[:, None]),
                             best[:, None], tokens)
        new_state, new_out = model.predictor_step(pred_state, best)
        pred_state = torch.where(emit[:, None], new_state, pred_state)
        pred_out = torch.where(emit[:, None], new_out, pred_out)
        u = torch.where(emit, u + 1, u)
        emitted_here = torch.where(emit, emitted_here + 1, 0)
        t = torch.where(active & ~emit, t + 1, t)
        return (t, u, emitted_here, best, pred_state, pred_out, tokens)

    return decoding.run_drain("greedy", model, body, dec, enc, p0,
                              frame_bound, C + min(C * max_symbols,
                                                   max_length),
                              (blank, max_symbols, "before"))


def _old_beam(model, state, enc, p0, frame_bound, max_symbols=4, blank=0):
    N, C, Hh = enc.shape
    B, L = state[2].shape[1], state[2].shape[2]
    K = min(B, model.vocab_size - 1)

    def body(state, consts):
        enc, frame_bound, p0 = consts
        (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
         pred_out) = state
        dev = enc.device
        l_iota = torch.arange(L, device=dev)[None, None, :]
        i_iota = torch.arange(B, device=dev)[None, :, None]
        j_iota = torch.arange(B, device=dev)[None, None, :]
        frame_on = (t < frame_bound)[:, None]
        f_t = decoding.frame_at(enc, t, p0)
        logp = model.joint_step(
            f_t[:, None, :].expand(N, B, Hh).reshape(N * B, Hh),
            pred_out.reshape(N * B, -1)).reshape(N, B, -1)
        alive = scores > 0.5 * NEG
        expandable = (frame_on & alive & ~waiting & (u < L)
                      & (nexp < max_symbols))
        settle = torch.where(frame_on & ~waiting, scores + logp[..., blank],
                             scores)
        lab_logp = logp.clone()
        lab_logp[..., blank] = NEG
        top_lp, top_ids = _top_k_small(lab_logp, K)
        lab_scores = torch.where(expandable[..., None],
                                 scores[..., None] + top_lp, NEG)
        cand = torch.cat([settle[..., None], lab_scores], -1)
        new_scores, sel = _top_k_small(cand.reshape(N, B * (K + 1)), B)
        parent = sel // (K + 1)
        kind = sel % (K + 1)
        tokens = _gather_beams(tokens, parent)
        u = _gather_beams(u, parent)
        nexp = _gather_beams(nexp, parent)
        hcode = _gather_beams(hcode, parent)
        pred_state = _gather_beams(pred_state, parent)
        pred_out = _gather_beams(pred_out, parent)
        scores = new_scores
        emit = kind > 0
        new_tok = _gather_beams(top_ids, parent).gather(
            2, (kind - 1).clamp(min=0).long()[..., None])[..., 0]
        tokens = torch.where(emit[..., None] & (l_iota == u[..., None]),
                             new_tok[..., None], tokens)
        adv_state, adv_out = model.predictor_step(
            pred_state.reshape(N * B, -1), new_tok.reshape(-1))
        pred_state = torch.where(emit[..., None],
                                 adv_state.reshape(N, B, -1), pred_state)
        pred_out = torch.where(emit[..., None], adv_out.reshape(N, B, -1),
                               pred_out)
        u = torch.where(emit, u + 1, u)
        nexp = torch.where(emit, nexp + 1, nexp)
        hcode = torch.where(emit, _hash_step(hcode, new_tok), hcode)
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

    return decoding.run_drain("beam", model, body, state, enc, p0,
                              frame_bound, C * (max_symbols + 1),
                              (blank, max_symbols, "before"))



def _old_first_output(model, n):
    pred_state = model.predictor_init(n)
    sos = torch.full((n,), -1, dtype=torch.int32)
    return model.predictor_step(pred_state, sos)[1]


@pytest.fixture(scope="module", params=[
    ("add", torch.bfloat16), ("add", torch.float32),
    ("concat", torch.bfloat16), ("concat", torch.float32)],
    ids=lambda p: f"{p[0]}-{str(p[1])[6:]}")
def model_and_frames(request):
    mode, cd = request.param
    model = init_model(3, vocab_size=V, feat_dim=F, N=N, T=T, U=5,
                       device="cpu", encoder_hidden=H,
                       predictor_hidden=16 if mode == "concat" else H,
                       joint_hidden=20, joint_mode=mode, compute_dtype=cd)[0]
    feats = torch.tensor(np.random.RandomState(5).randn(N, T, F)
                         .astype(np.float32))
    with torch.inference_mode():
        enc = model.encode(feats)
    return model, enc


def test_decode_consts_layout(model_and_frames):
    model, _ = model_and_frames
    dc = decoding.decode_consts(model)
    w_pre, b_pre, w_out, b_out, b_hh = dc.tensors
    j = model.joint
    assert dc.mode == j.mode and dc.dtype == j.compute_dtype
    assert (dc.hidden, dc.vocab) == (20, V)
    for w, lin in ((w_pre, j.pre), (w_out, j.out)):
        assert w.is_contiguous() and w.dtype == j.compute_dtype
        assert tuple(w.shape) == (lin.in_features, lin.out_features)
        assert torch.equal(w, lin.weight.t().to(j.compute_dtype))
    assert torch.equal(b_pre, j.pre.bias.to(j.compute_dtype))
    assert torch.equal(b_out, j.out.bias.to(j.compute_dtype))
    assert torch.equal(b_hh, model.predictor._gru_params()[3])


@pytest.mark.parametrize("unroll", [1, 5])
def test_lifted_greedy_step_equals_the_step_before(model_and_frames, unroll):
    model, enc = model_and_frames
    xn = torch.tensor(XN)
    with torch.inference_mode(), device_loop.unrolled(unroll):
        dec = decoding.greedy_state_init(model, N, ML)
        before = list(dec)
        before[5] = _old_first_output(model, N)
        assert torch.equal(dec[5], before[5])
        got = decoding.greedy_drain(model, dec, enc, 0, xn)
        want = _old_greedy(model, tuple(before), enc, 0, xn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("unroll", [1, 5])
def test_lifted_beam_step_equals_the_step_before(model_and_frames, unroll):
    model, enc = model_and_frames
    xn = torch.tensor(XN)
    with torch.inference_mode(), device_loop.unrolled(unroll):
        st = beam_search.beam_state_init(model, N, B, ML)
        before = list(st)
        before[8] = _old_first_output(model, N * B).reshape(N, B, -1)
        assert torch.equal(st[8], before[8])
        got = beam_search.beam_drain(model, st, enc, 0, xn)
        want = _old_beam(model, tuple(before), enc, 0, xn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- the plain versions against JAX ----

@pytest.fixture(scope="module", params=["fp32", "bf16"])
def carried(request):
    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair(request.param, 2, feats, V, H)
    return request.param, model.bind(params), port


def _rows(seed, rows, width, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(rows, width)
            ).astype(np.float32)


@pytest.mark.parametrize("per_sample", [1, B])
def test_decode_joint_plain_matches_jax_joint_step(carried, per_sample):
    variant, bound, port = carried
    rows = N * per_sample
    f = _rows(11, N, H)
    g = _rows(12, rows, H, 0.5)
    want = np.asarray(bound.joint_step(
        jnp.asarray(np.repeat(f, per_sample, axis=0)), jnp.asarray(g)))
    dc = decoding.decode_consts(port)
    # the frames as a chunk of width 3 read at t - p0 = 1
    enc = torch.tensor(np.stack([f * 0, f, f * 0], axis=1))
    t = torch.full((N,), 6, dtype=torch.int32)
    logp = torch.empty((rows, V))
    with torch.inference_mode():
        best = ds.decode_joint(enc, t, torch.tensor(5, dtype=torch.int32),
                               torch.tensor(g), *dc.tensors[:4], dc.mode, 0,
                               None, logp)
    if variant == "fp32":
        np.testing.assert_allclose(logp.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(best.numpy(), np.argmax(want, -1))
        return
    logits = np.asarray(bound.joint(
        jnp.asarray(np.repeat(f, per_sample, axis=0))[:, None],
        jnp.asarray(g)[:, None], normalize=False))[:, 0, 0]
    tol = dsc.logp_tol(torch.tensor(logits), torch.bfloat16).numpy()
    assert (np.abs(logp.numpy() - want) <= tol).all()
    top2 = np.sort(want, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol[:, 0]
    assert sure.sum() >= rows // 2
    np.testing.assert_array_equal(best.numpy()[sure],
                                  np.argmax(want, -1)[sure])


def test_decode_joint_plain_beam_matches_jax_top_k(carried):
    """The beam epilogue on the port's log-probs equals JAX's body on the
    same log-probs: the blank's value and `_top_k_small` of the rest."""
    _, _, port = carried
    rows, k = N * B, B
    dc = decoding.decode_consts(port)
    enc = torch.tensor(_rows(21, N, H))[:, None]
    logp = torch.empty((rows, V))
    with torch.inference_mode():
        lp_blank, top_lp, top_ids = ds.decode_joint(
            enc, torch.zeros(N, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.tensor(_rows(22, rows, H, 0.5)), *dc.tensors[:4], dc.mode,
            4, k, logp)
    x = jnp.asarray(logp.numpy())
    v, i = jax_top_k(x.at[:, 4].set(JAX_NEG), k)
    np.testing.assert_array_equal(lp_blank.numpy(), logp.numpy()[:, 4])
    np.testing.assert_array_equal(top_lp.numpy(), np.asarray(v))
    np.testing.assert_array_equal(top_ids.numpy(), np.asarray(i))


def _epilogue_cases():
    rng = np.random.RandomState(7)
    tied = rng.randint(0, 3, (6, 9)).astype(np.float32)
    neg = rng.randn(5, 8).astype(np.float32)
    neg[0, :] = -np.inf
    neg[1, 2:] = -np.inf
    neg[2, :3] = -np.inf
    small = rng.randn(4, 3).astype(np.float32)  # V = 3 <= K + 1 at k=2
    return {"ties": tied, "neg_inf": neg, "small_v": small}


@pytest.mark.parametrize("case", ["ties", "neg_inf", "small_v"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_beam_epilogue_matches_jax(case, where):
    x = _epilogue_cases()[case]
    V_ = x.shape[1]
    blank = 0 if where == "first" else V_ - 1
    for k in range(1, V_):
        lp_blank, top_lp, top_ids = ds.epilogue_plain(torch.tensor(x), blank,
                                                      k)
        v, i = jax_top_k(jnp.asarray(x).at[:, blank].set(JAX_NEG), k)
        np.testing.assert_array_equal(lp_blank.numpy(), x[:, blank])
        np.testing.assert_array_equal(top_lp.numpy(), np.asarray(v))
        np.testing.assert_array_equal(top_ids.numpy(), np.asarray(i))
        assert all(len(set(r)) == k for r in top_ids.tolist())
    best = ds.epilogue_plain(torch.tensor(x), blank)
    np.testing.assert_array_equal(best.numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), -1)))


def _gru_inputs(port, rows, seed):
    rng = np.random.RandomState(seed)
    token = torch.tensor(rng.randint(-1, V, rows).astype(np.int32))
    token[0] = -1
    h = torch.tensor(_rows(seed + 1, rows, H, 0.5))
    out = torch.tensor(_rows(seed + 2, rows, H, 0.5))
    emit = torch.tensor(rng.randint(0, 2, rows).astype(bool))
    emit[0] = True
    return token, h, out, emit


def test_decode_gru_plain_equals_predictor_step_and_wheres(carried):
    _, bound, port = carried
    token, h, out, emit = _gru_inputs(port, 2 * N, 31)
    with torch.inference_mode():
        got_h, got_out = ds.decode_gru(token, h, out, emit,
                                       *decoding.gru_params(port),
                                       port.predictor.recurrent_bias())
        new, new_out = port.predictor_step(h, token)
    assert torch.equal(got_h, torch.where(emit[:, None], new, h))
    assert torch.equal(got_out, torch.where(emit[:, None], new_out, out))
    want, _ = bound.predictor_step(jnp.asarray(h.numpy()),
                                   jnp.asarray(token.numpy()))
    np.testing.assert_allclose(got_h.numpy()[emit.numpy()],
                               np.asarray(want)[emit.numpy()], rtol=0,
                               atol=1e-5)


def test_decode_gru_greedy_plain_equals_the_masked_update(carried):
    _, _, port = carried
    rng = np.random.RandomState(41)
    rows = 2 * N
    best, h, out, _ = _gru_inputs(port, rows, 43)
    best = best.clamp(min=0)
    best[1] = 0  # a blank
    t = torch.tensor(rng.randint(0, 6, rows).astype(np.int32))
    u = torch.tensor(rng.randint(0, ML + 1, rows).astype(np.int32))
    eh = torch.tensor(rng.randint(0, 5, rows).astype(np.int32))
    fb = torch.tensor(rng.randint(0, 6, rows).astype(np.int32))
    tokens = torch.tensor(rng.randint(0, V, (rows, ML)).astype(np.int32))
    gru = (*decoding.gru_params(port), port.predictor.recurrent_bias())
    with torch.inference_mode():
        got = ds.decode_gru_greedy(best, t, u, eh, fb, tokens, h, out, *gru,
                                   0, 4)
        l_iota = torch.arange(ML)[None, :]
        active = t < fb
        emit = active & (best != 0) & (u < ML) & (eh < 4)
        new, _ = port.predictor_step(h, best)
        want = (torch.where(active & ~emit, t + 1, t),
                torch.where(emit, u + 1, u), torch.where(emit, eh + 1, 0),
                torch.where(emit[:, None] & (l_iota == u[:, None]),
                            best[:, None], tokens),
                torch.where(emit[:, None], new, h),
                torch.where(emit[:, None], new, out))
    assert 0 < int(emit.sum()) < rows
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- the card checks' code on the CPU (both sides the plain version) ----

def test_odd_cases_run_on_the_cpu():
    out = dsc.odd_cases(device="cpu")
    assert len(out) == 2 * 2 * len(dsc.ODD_ROWS)
    for case in out.values():
        assert all(r["max_abs_err"] == 0.0 for r in case.values())


def test_recorded_states_check_on_the_cpu():
    d = dict(sc.SMALL, beam=2)
    model = sc.carried_model(d, 1, "cpu", torch.float32)
    feats = sc.features(2, d["N"], d["T"], d["F"], "cpu")
    xn = sc.ragged(d["N"], d["T"], "cpu")
    recs, outs = dsc.record_states(model, feats, xn, d["max_length"],
                                   d["beam"], every=4)
    out = dsc.check_records(recs)
    assert set(out) == {"greedy", "beam"}
    assert set(out["greedy"]) == {"decode_joint", "decode_gru",
                                  "decode_gru_greedy"}
    assert set(out["beam"]) == {"decode_joint", "decode_gru"}
    for dec in out.values():
        for s in dec.values():
            assert s["calls"] >= 1 and s["max_abs_err"] == 0.0
    agree = dsc.token_agreement(model, feats, xn, d["max_length"], d["beam"],
                                outs)
    assert all(a["equal_share"] == 1.0 and a["first"] == []
               for a in agree.values())
