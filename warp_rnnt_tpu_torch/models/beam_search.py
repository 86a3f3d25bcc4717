"""Batched RNN-T beam search, time-asynchronous (counterpart of
`warp_rnnt_tpu/models/beam_search.py`).

One loop whose body does one joint evaluation and one dense top-k for the
whole batch, with JAX's algorithm step for step:

  * every sample carries its own frame pointer t (as `greedy_decode`);
  * per step every active beam proposes one blank candidate (settles the
    beam for its frame) and its top ``beam_size`` label candidates (emit:
    append the token, advance the predictor, stay active); settled beams
    propose themselves; a dense top-k keeps ``beam_size`` hypotheses;
  * the per-frame emission cap (``max_symbols_per_step``) is enforced by
    the candidate mask: a capped beam's only candidate is its blank;
  * a sample whose live beams are all settled advances t in the same step.

Duplicate hypotheses (the same label prefix reached in another order) are
max-merged after every selection, compared on an O(B^2) rolling hash of the
prefix.  JAX's hash is uint32; here it is int64 masked to 32 bits after
each ``h * 1000003 + tok + 1``.  The product stays below 2^53, so every
hash equals JAX's wrap-around value bit for bit.

The top-k is `_top_k_small`, k argmax rounds, as in JAX: ``torch.topk``
leaves the order among ties unspecified, while ``torch.argmax`` returns
the first maximal index, as JAX's ties break to the lowest index.

The loop is `utils.device_loop.while_loop` on JAX's ``cond``, through
`decoding.run_drain` as greedy's (one CUDA graph of masked steps on the
card; a surplus step re-sorts nothing, since the mask is the global
``cond``), its trip count and host reads added to
`decoding.LOOP_ITERATIONS["beam"]` and `decoding.HOST_READS["beam"]`.  Scores are best-alignment (Viterbi-style)
log-probs.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.models.decoding import frame_at, run_drain

NEG = -1.0e30
_HASH_MUL = 1000003
_HASH_MASK = 0xFFFFFFFF


def _hash_step(hcode, tok):
    """The rolling prefix hash after appending ``tok``: JAX's uint32
    ``h * 1000003 + tok + 1`` with wrap-around, on int64 in [0, 2^32)."""
    return (hcode * _HASH_MUL + (tok.long() + 1)) & _HASH_MASK


def _top_k_small(x, k):
    """Exact top-k over the trailing axis for small k, as k argmax rounds.

    Selection runs on a copy whose -inf entries are clamped to the dtype's
    finite minimum, and each picked index is masked to -inf: so the
    indices stay distinct even when fewer than k entries are finite
    (exhausted slices fall back to ascending first-unpicked indices).
    Values are gathered from the original x, so -inf entries report -inf.
    Ties go to the lowest index.
    """
    vals, ids = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    sel = x.clamp(min=torch.finfo(x.dtype).min)
    for _ in range(k):
        i = sel.argmax(dim=-1)
        vals.append(x.gather(-1, i[..., None])[..., 0])
        ids.append(i)
        sel = torch.where(iota == i[..., None], -torch.inf, sel)
    return torch.stack(vals, -1), torch.stack(ids, -1).to(torch.int32)


@torch.inference_mode()
def beam_decode(model, feats, xn, max_length: int, beam_size: int = 4,
                max_symbols_per_step: int = 4, blank: int = 0):
    """Batched beam search.

    Args:
      model: a `Transducer` (encode / predictor_init / predictor_step /
        joint_step, as `greedy_decode` uses).
      feats: (N, T, F) features;  xn: (N,) int valid frame counts.
      max_length: bound on emitted symbols per utterance.
      beam_size: beam width B.
      max_symbols_per_step: emission expansions a frame before a forced
        blank.
      blank: blank id.

    Returns:
      tokens (N, max_length) int32 of the best hypothesis (blank-padded),
      lengths (N,) int32, scores (N,) fp32 (best-alignment log-prob).
    """
    enc = model.encode(feats)  # (N, T, H)
    xn = torch.as_tensor(xn, dtype=torch.int32, device=enc.device)
    state = beam_state_init(model, enc.shape[0], beam_size, max_length, blank)
    state = beam_drain(model, state, enc, 0, xn,
                       max_symbols_per_step=max_symbols_per_step, blank=blank)
    return beam_best(state)


def beam_best(state):
    """The best hypothesis of a beam state: (tokens, lengths, scores)."""
    scores, tokens, u = state[1], state[2], state[3]
    best = scores.argmax(dim=1)
    n_iota = torch.arange(scores.shape[0], device=scores.device)
    return tokens[n_iota, best], u[n_iota, best], scores[n_iota, best]


@torch.inference_mode()
def beam_state_init(model, N, beam_size, max_length, blank: int = 0):
    """A fresh beam-search state (only beam 0 live, <sos> predictor):
    (t, scores, tokens, u, nexp, waiting, hcode, pred_state, pred_out)."""
    B, L = beam_size, max_length
    flat = model.predictor_init(N * B)
    dev = flat.device
    _, out0 = model.predictor_step(
        flat, torch.full((N * B,), -1, dtype=torch.int32, device=dev))
    scores = torch.full((N, B), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0

    def zeros(dtype=torch.int32):
        return torch.zeros((N, B), dtype=dtype, device=dev)

    return (
        torch.zeros((N,), dtype=torch.int32, device=dev),  # frame pointer
        scores,
        torch.full((N, B, L), blank, dtype=torch.int32, device=dev),
        zeros(),  # emitted length u
        zeros(),  # emissions at the current frame
        zeros(torch.bool),  # settled ("waiting") for the current frame
        zeros(torch.int64),  # rolling prefix hash, in [0, 2^32)
        flat.reshape(N, B, -1),
        out0.reshape(N, B, -1),
    )


def _gather_beams(x, parent):
    """x (N, B, ...) -> x[n, parent[n, b], ...]."""
    idx = parent.long().reshape(parent.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(parent.shape + x.shape[2:]))


@torch.inference_mode()
def beam_drain(model, state, enc, p0, frame_bound,
               max_symbols_per_step: int = 4, blank: int = 0):
    """Advance a beam-search state over the available encoder frames.

    As `decoding.greedy_drain`: ``enc`` (N, C, H) holds frames for stream
    positions [p0, p0 + C); each sample consumes frames while its frame
    pointer t < frame_bound.  The body is strictly per-frame sequential, so
    pausing at any chunk boundary and resuming gives the one-shot decode
    exactly; `beam_decode` (whole utterance, p0 = 0, frame_bound = xn) and
    the streaming session both call it.

    The loop's bound: at a frame's start every live beam is active with
    nexp = 0; an active beam after the frame's j-th step was born of an
    emission in it, so has nexp = j.  After max_symbols_per_step + 1 steps
    no live beam can still be active (an emission past the cap has only a
    NEG candidate), and the sample advances in that step.  So a sample
    takes at most C * (max_symbols_per_step + 1) steps."""
    N, C, H = enc.shape
    B, L = state[2].shape[1], state[2].shape[2]
    K = min(B, model.vocab_size - 1)  # label candidates a beam

    def body(state, consts):
        enc, frame_bound, p0 = consts
        (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
         pred_out) = state
        dev = enc.device
        l_iota = torch.arange(L, device=dev)[None, None, :]
        i_iota = torch.arange(B, device=dev)[None, :, None]
        j_iota = torch.arange(B, device=dev)[None, None, :]
        frame_on = (t < frame_bound)[:, None]  # (N, 1)
        f_t = frame_at(enc, t, p0)  # (N, H)
        logp = model.joint_step(
            f_t[:, None, :].expand(N, B, H).reshape(N * B, H),
            pred_out.reshape(N * B, -1),
        ).reshape(N, B, -1)  # (N, B, V)

        # a beam may expand while its sample's frame is live, it has not
        # settled this frame, it has token budget and is under the cap
        alive = scores > 0.5 * NEG
        expandable = (frame_on & alive & ~waiting & (u < L)
                      & (nexp < max_symbols_per_step))

        # column 0: blank (active beams) / self (settled or off-frame)
        settle = torch.where(frame_on & ~waiting, scores + logp[..., blank],
                             scores)
        # columns 1..K: the top-K labels (blank masked out)
        lab_logp = logp.clone()
        lab_logp[..., blank] = NEG
        top_lp, top_ids = _top_k_small(lab_logp, K)  # (N, B, K)
        lab_scores = torch.where(expandable[..., None],
                                 scores[..., None] + top_lp, NEG)
        cand = torch.cat([settle[..., None], lab_scores], -1)

        new_scores, sel = _top_k_small(cand.reshape(N, B * (K + 1)), B)
        parent = sel // (K + 1)  # (N, B)
        kind = sel % (K + 1)  # 0 = blank/self

        tokens = _gather_beams(tokens, parent)
        u = _gather_beams(u, parent)
        nexp = _gather_beams(nexp, parent)
        hcode = _gather_beams(hcode, parent)
        pred_state = _gather_beams(pred_state, parent)
        pred_out = _gather_beams(pred_out, parent)
        scores = new_scores
        emit = kind > 0

        new_tok = _gather_beams(top_ids, parent).gather(
            2, (kind - 1).clamp(min=0).long()[..., None])[..., 0]  # (N, B)
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
        # blank/self settles the beam for this frame; emits stay active
        waiting = frame_on & ~emit

        # merge duplicate hypotheses: the same hash (the same prefix, but
        # for a 32-bit collision), length and within-frame state are one
        # hypothesis; the better-scored copy survives (ties: lower index)
        same = ((hcode[:, :, None] == hcode[:, None, :])
                & (u[:, :, None] == u[:, None, :])
                & (waiting[:, :, None] == waiting[:, None, :]))
        s_i = scores[:, :, None]
        s_j = scores[:, None, :]
        beats = (s_i > s_j) | ((s_i == s_j) & (i_iota < j_iota))
        killed = (same & beats & (i_iota != j_iota)).any(dim=1)
        scores = torch.where(killed, NEG, scores)

        # a sample whose live beams are all settled is done with this
        # frame: advance its pointer and re-arm every beam
        active = ~waiting & (scores > 0.5 * NEG)
        advance = (t < frame_bound) & ~active.any(dim=1)
        t = torch.where(advance, t + 1, t)
        waiting = waiting & ~advance[:, None]
        nexp = torch.where(advance[:, None], 0, nexp)
        return (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
                pred_out)

    return run_drain("beam", model, body, state, enc, p0, frame_bound,
                     C * (max_symbols_per_step + 1),
                     (blank, max_symbols_per_step))
