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
the first maximal index, as JAX's ties break to the lowest index.  The
step is three calls of `ops.decode_step` (one launch each but the
joint's three) on the invariants of `decoding.decode_consts`:
`decode_joint`, each beam's blank log-prob and top labels;
`decode_beam_select`, the candidates' top-k, the beams' gathers, the
token write, the hash, the merge and the frame advance, which also gives
each new beam's emit mask, token and parent row; and `decode_gru`, the
GRU cell masked by the emissions, reading each beam's predictor state
and output from its parent's row (``src``).  `decode_beam_select_plain`
holds the step's torch code as it ran before that kernel.

The loop is `utils.device_loop.while_loop` on JAX's ``cond``, through
`decoding.run_drain` as greedy's (on the card one CUDA graph while node
over rounds of masked steps; a surplus step re-sorts nothing, since the
mask is the global ``cond``), its trip count and host reads added to
`decoding.LOOP_ITERATIONS["beam"]` and `decoding.HOST_READS["beam"]`
(`compiled_beam_decode`: the whole decode one CUDA graph a shape, as
`decoding.compiled_greedy_decode`).  On
`ops.decode_step` the loop is folded (`decoding.folds`):
`decode_beam_select` computes ``cond`` from the step's inputs, writes the
beam state through where it is false, with no emission and each row its
own parent (so `decode_gru` copies every row), and counts the step; a
step is then its five launches.  Scores are best-alignment (Viterbi-style)
log-probs.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.models.decoding import (
    compiled_key,
    decode_consts,
    first_output,
    folds,
    gru_params,
    run_drain,
)
from warp_rnnt_tpu_torch.ops import decode_step
# the step's helpers, kept once in ops.decode_step and read here under
# their earlier names
from warp_rnnt_tpu_torch.ops.decode_step import (  # noqa: F401
    _HASH_MUL,
    NEG,
    gather_beams as _gather_beams,
    hash_step as _hash_step,
    top_k_small as _top_k_small,
)
from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

COMPILED = "beam_search.compiled_beam_decode"  # its graphs' key name


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


def compiled_beam(model, max_length: int, beam_size: int = 4,
                  max_symbols_per_step: int = 4, blank: int = 0):
    """`beam_decode` of these arguments as a `CompiledStep`
    ``step(feats, xn (N,) int32) -> (tokens, lengths, scores)``."""
    return compiled_step(
        lambda f, n: beam_decode(model, f, n, max_length, beam_size,
                                 max_symbols_per_step, blank),
        key=compiled_key(COMPILED, model, max_length, beam_size,
                         max_symbols_per_step, blank))


@torch.inference_mode()
def compiled_beam_decode(model, feats, xn, max_length: int,
                         beam_size: int = 4, max_symbols_per_step: int = 4,
                         blank: int = 0):
    """`beam_decode` compiled once per shape, `beam_best` inside the graph
    (as `decoding.compiled_greedy_decode`): the same arguments and
    results, the results the graph's static buffers on the card."""
    xn = torch.as_tensor(xn, dtype=torch.int32, device=feats.device)
    return compiled_beam(model, max_length, beam_size, max_symbols_per_step,
                         blank)(feats, xn)


def beam_best(state):
    """The best hypothesis of a beam state: (tokens, lengths, scores)."""
    scores, tokens, u = state[1], state[2], state[3]
    best = scores.argmax(dim=1)
    n_iota = torch.arange(scores.shape[0], device=scores.device)
    return tokens[n_iota, best], u[n_iota, best], scores[n_iota, best]


@torch.inference_mode()
def beam_state_init(model, N, beam_size, max_length, blank: int = 0, *,
                    ops=decode_step):
    """A fresh beam-search state (only beam 0 live, <sos> predictor, its
    first step on ``ops``): (t, scores, tokens, u, nexp, waiting, hcode,
    pred_state, pred_out)."""
    B, L = beam_size, max_length
    flat = model.predictor_init(N * B)
    dev = flat.device
    out0 = first_output(model, N * B, ops)
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


@torch.inference_mode()
def beam_drain(model, state, enc, p0, frame_bound,
               max_symbols_per_step: int = 4, blank: int = 0, *,
               ops=decode_step):
    """Advance a beam-search state over the available encoder frames.

    As `decoding.greedy_drain`: ``enc`` (N, C, H) holds frames for stream
    positions [p0, p0 + C); each sample consumes frames while its frame
    pointer t < frame_bound.  The body is strictly per-frame sequential, so
    pausing at any chunk boundary and resuming gives the one-shot decode
    exactly; `beam_decode` (whole utterance, p0 = 0, frame_bound = xn) and
    the streaming session both call it.  The step runs on ``ops``
    (`ops.decode_step`, or `decode_step.PLAIN`).

    The loop's bound: at a frame's start every live beam is active with
    nexp = 0; an active beam after the frame's j-th step was born of an
    emission in it, so has nexp = j.  After max_symbols_per_step + 1 steps
    no live beam can still be active (an emission past the cap has only a
    NEG candidate), and the sample advances in that step.  So a sample
    takes at most C * (max_symbols_per_step + 1) steps.  On
    `ops.decode_step` the loop is folded (module docstring)."""
    N, C, _ = enc.shape
    B, L = state[2].shape[1], state[2].shape[2]
    K = min(B, model.vocab_size - 1)  # label candidates a beam
    dc = decode_consts(model)
    gru = gru_params(model)

    def body(state, consts, count=None):
        # count: the loop's, where the selection folds in its mask and count
        enc, frame_bound, p0, w_pre, b_pre, w_out, b_out, b_hh = consts
        (t, scores, tokens, u, nexp, waiting, hcode, pred_state,
         pred_out) = state
        # each beam's blank log-prob and its top-K labels (blank masked)
        lp_blank, top_lp, top_ids = ops.decode_joint(
            enc, t, p0, pred_out.reshape(N * B, -1), w_pre, b_pre, w_out,
            b_out, dc.mode, blank, K)
        # the candidates' top-k, the beams' gathers, the token write, the
        # hash, the merge and the frame advance
        fold = () if count is None else (count,)
        (t, scores, tokens, u, nexp, waiting, hcode, emit, new_tok, src,
         *fold) = ops.decode_beam_select(
            t, scores, tokens, u, nexp, waiting, hcode, lp_blank, top_lp,
            top_ids, frame_bound, max_symbols_per_step, *fold)
        # the predictor on the emitted tokens, reading each beam's parent
        pred_state, pred_out = ops.decode_gru(
            new_tok, pred_state.reshape(N * B, -1),
            pred_out.reshape(N * B, -1), emit, *gru, b_hh, src=src)
        new = (t, scores, tokens, u, nexp, waiting, hcode,
               pred_state.reshape(N, B, -1), pred_out.reshape(N, B, -1))
        return (new, *fold) if fold else new

    return run_drain("beam", model, body, state, enc, p0, frame_bound,
                     C * (max_symbols_per_step + 1),
                     (blank, max_symbols_per_step, ops.__name__), dc.tensors,
                     folds(ops))
