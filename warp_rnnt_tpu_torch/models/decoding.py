"""Greedy RNN-T decoding, batched (counterpart of
`warp_rnnt_tpu/models/decoding.py`).

Standard greedy transducer search: at lattice cell (t, u) take the argmax
of the joint; a blank advances t, a label advances the predictor and
appends the token.  Every sample carries its own frame pointer t, and a
per-frame emission cap (``max_symbols_per_step``) bounds the loop.

JAX's ``lax.while_loop`` becomes `utils.device_loop.while_loop` with
JAX's ``cond`` and ``body``: on the card, rounds of masked steps replayed
from one CUDA graph, with one host read of the loop's flag a round; on
the CPU the same steps run eagerly.  The mask is JAX's ``cond`` itself, so
a step past JAX's stopping point leaves the whole state bit for bit (it
would otherwise rewrite ``emitted_here`` and ``last_tok``).  A drain adds
JAX's trip count, read from the loop's device counter, to
``LOOP_ITERATIONS[name]``, and its host reads to ``HOST_READS[name]``.

A graph is keyed by the shapes of the loop's inputs, and the encoder
frames are one of them, so a one-shot decode of each utterance length
would capture a graph of its own.  `run_drain` pads the frames' axis to
the next power of two by repeating the last frame (`pad_frames`): a
frame is read at ``clamp(t - p0, 0, C - 1)``, so every read gives the
frame it gave before, bit for bit, and the trip count, which reads only
t and the bounds, is unchanged.  Lengths 257 to 512 share one graph.

The port's modules hold their parameters, so the functions take the model
and no ``params``; the decode runs under ``torch.inference_mode()`` on the
model's device.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.utils.device_loop import while_loop

# Loop iterations (JAX's trip count) and the host's reads of the loop's
# flag, by decoder; `bench_decode` sets them to 0 before a decode and reads
# them after.  LAST_GRAPH: the device loop's graph entry of the decoder's
# last drain (None where it ran eagerly), for the benchmarks.
LOOP_ITERATIONS = {"greedy": 0, "beam": 0}
HOST_READS = {"greedy": 0, "beam": 0}
LAST_GRAPH = {"greedy": None, "beam": None}


def _frames_left(state, consts):
    """JAX's ``cond`` of both decoders: some sample's t < frame_bound."""
    return (state[0] < consts[1]).any()


def pad_frames(enc):
    """enc (N, C, H) -> (N, C', H), C' the least power of two >= C, the
    last frame repeated into the new columns (one zero frame when C is
    0, which no sample reads): `frame_at` reads the same frames from it."""
    N, C, H = enc.shape
    width = 1 << max(C - 1, 0).bit_length()
    if width == C:
        return enc
    fill = enc[:, -1:] if C else enc.new_zeros((N, 1, H))
    return torch.cat([enc, fill.expand(N, width - C, H)], dim=1)


def run_drain(name, model, body, state, enc, p0, frame_bound,
              max_iterations, static):
    """Run decoder ``name``'s ``body`` while a sample has frames left, on
    `while_loop`, and add its trip count and host reads to the counters.
    The loop's inputs are (`pad_frames(enc)`, frame_bound (N,) int32, p0
    0-d int32); its graphs are keyed by ``name``, the model (the object
    and its parameters' addresses, dtypes and shapes: what the body closes
    over) and the ``static`` arguments the body closes over."""
    dev = enc.device
    frame_bound = torch.as_tensor(frame_bound, dtype=torch.int32, device=dev)
    consts = (pad_frames(enc), frame_bound.expand(enc.shape[0]),
              torch.as_tensor(p0, dtype=torch.int32, device=dev))
    params = tuple((p.data_ptr(), p.dtype, tuple(p.shape))
                   for p in (*model.parameters(), *model.buffers()))
    state, stats = while_loop(_frames_left, body, state, consts,
                              max_iterations=max_iterations,
                              key=(name, id(model), params, *static))
    LOOP_ITERATIONS[name] += stats.iterations
    HOST_READS[name] += stats.host_reads
    LAST_GRAPH[name] = stats.graph
    return state


def frame_at(enc, t, p0):
    """enc (N, C, H) holding stream positions [p0, p0 + C) -> the frame at
    each sample's position t (N,), clipped into the chunk: (N, H)."""
    N, C, H = enc.shape
    idx = (t - p0).clamp(0, C - 1).long()
    return enc.gather(1, idx[:, None, None].expand(N, 1, H))[:, 0]


@torch.inference_mode()
def greedy_decode(model, feats, xn, max_length: int,
                  max_symbols_per_step: int = 4, blank: int = 0):
    """Batched greedy decode.

    Args:
      model: a `Transducer` (encode / predictor_init / predictor_step /
        joint_step).
      feats: (N, T, F) acoustic features, on the model's device.
      xn: (N,) int valid frame counts.
      max_length: bound on emitted symbols per utterance.
      max_symbols_per_step: cap on consecutive non-blank emissions a frame.
      blank: blank id.

    Returns:
      tokens (N, max_length) int32 (blank-padded), lengths (N,) int32.
    """
    enc = model.encode(feats)  # (N, T, H)
    xn = torch.as_tensor(xn, dtype=torch.int32, device=enc.device)
    dec = greedy_state_init(model, enc.shape[0], max_length, blank)
    dec = greedy_drain(model, dec, enc, 0, xn,
                       max_symbols_per_step=max_symbols_per_step, blank=blank)
    return dec[6], dec[1]


@torch.inference_mode()
def greedy_state_init(model, N, max_length: int, blank: int = 0):
    """Fresh greedy decode state: (t, u, emitted_here, last_tok,
    pred_state, pred_out, tokens)."""
    pred_state = model.predictor_init(N)
    dev = pred_state.device
    sos = torch.full((N,), -1, dtype=torch.int32, device=dev)
    _, pred_out = model.predictor_step(pred_state, sos)

    def zeros():
        return torch.zeros((N,), dtype=torch.int32, device=dev)

    return (
        zeros(),  # t (next frame to consume)
        zeros(),  # u (emitted)
        zeros(),  # emitted at the current frame
        sos,  # last token (<sos>)
        pred_state,
        pred_out,
        torch.full((N, max_length), blank, dtype=torch.int32, device=dev),
    )


@torch.inference_mode()
def greedy_drain(model, dec, enc, p0, frame_bound,
                 max_symbols_per_step: int = 4, blank: int = 0):
    """Advance a greedy decode state over the available encoder frames.

    ``enc`` (N, C, H) holds frames for stream positions [p0, p0 + C); each
    sample consumes frames while its t < frame_bound (per sample, clipped
    by the caller to what enc covers).  Used by the one-shot
    `greedy_decode` (enc = the whole utterance, p0 = 0, frame_bound = xn)
    and by the streaming session (`models/streaming.py`).

    Each iteration of an active sample emits or advances t, so a sample
    takes at most C frame steps and min(C * max_symbols_per_step,
    max_length) emissions: the loop's bound."""
    C = enc.shape[1]
    max_length = dec[6].shape[1]

    def body(state, consts):
        enc, frame_bound, p0 = consts
        t, u, emitted_here, last_tok, pred_state, pred_out, tokens = state
        l_iota = torch.arange(max_length, device=enc.device)[None, :]
        active = t < frame_bound
        logp = model.joint_step(frame_at(enc, t, p0), pred_out)  # (N, V)
        best = logp.argmax(dim=-1).to(torch.int32)
        emit = (active & (best != blank) & (u < max_length)
                & (emitted_here < max_symbols_per_step))
        tokens = torch.where(emit[:, None] & (l_iota == u[:, None]),
                             best[:, None], tokens)
        new_state, new_out = model.predictor_step(pred_state, best)
        pred_state = torch.where(emit[:, None], new_state, pred_state)
        pred_out = torch.where(emit[:, None], new_out, pred_out)
        u = torch.where(emit, u + 1, u)
        emitted_here = torch.where(emit, emitted_here + 1, 0)
        t = torch.where(active & ~emit, t + 1, t)
        return (t, u, emitted_here, best, pred_state, pred_out, tokens)

    return run_drain("greedy", model, body, dec, enc, p0, frame_bound,
                     C + min(C * max_symbols_per_step, max_length),
                     (blank, max_symbols_per_step))
