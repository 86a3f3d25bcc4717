"""Streaming (chunked) transducer inference session (counterpart of
`warp_rnnt_tpu/models/streaming.py`).

Features arrive in chunks, the encoder runs statefully (per-conv-block
caches, an algorithmic delay of `Encoder.lookahead` frames), and the
greedy or beam decoder advances over the encoder frames as they become
available.  The session state is a dict, ``{"enc", "dec"}`` for greedy or
``{"enc", "dec_beam"}`` for beam search, of tensors on the model's device.

Exactness contract: feeding the same (N, T, F) features through any
chunking, ragged tail included, gives the one-shot `greedy_decode` (or,
with ``beam_size`` > 0, `beam_decode`: tokens, lengths and scores)
exactly.  The encoder masks out-of-stream frames to zero in LN-space in
each conv block, so the chunked warm-up and flush rows act as the
whole-utterance convolution's zero padding (`transducer.ConvBlock.stream`),
and the decoders' loops are strictly per frame.  The decoders' loops
take the chunk's frames, its position p0 and the frame bounds as the
loop's inputs (`utils.device_loop`), so on the card one CUDA graph serves
every chunk of one width; the ragged tail and the flush have other widths,
and so graphs of their own.

The encoder's chunk step (`Encoder.stream`, or `Encoder.stream_finish`,
and the frame bound after it) is compiled once per shape through
`utils.compiled_step`, as JAX jits `stream_step`: on the card one CUDA
graph a shape, keyed by the encoder and its parameters' addresses, N, C,
F, the dtypes, whether ``xn`` is given and the limit's kind (the
constant `_NO_LIMIT` in `stream_step`, the stream's length, an argument,
in `stream_finish`); on the CPU it runs eagerly, the plain version.  The
graph's outputs are static buffers that the next chunk of that shape
overwrites, whichever session sends it, so the new encoder carry is
cloned out of them (1 + 2 * blocks small copies a chunk) and every
session's state is its own: sessions of one shape may interleave.  A
chunk is then one encoder replay and the drain's while node, one launch
and one host read; the drains run folded on the step's kernels
(`decoding.folds`: the loop's mask and count in the GRU or the
selection), so a round is its steps' own launches and the round's tail.

Typical use::

    state = stream_init(model, N=8, max_length=64)
    for chunk in feature_chunks:            # (N, C, F) each
        state = stream_step(model, state, chunk)
    tokens, lengths, state = stream_finish(model, state)

For batch-padded inputs with ragged valid lengths pass the same ``xn`` to
every `stream_step` call and to `stream_finish`: decoding then stops per
sample at xn, as `greedy_decode` does.  Every function runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.models.beam_search import (
    beam_best,
    beam_drain,
    beam_state_init,
)
from warp_rnnt_tpu_torch.models.decoding import greedy_drain, greedy_state_init
from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

_NO_LIMIT = 2 ** 30  # "more frames are coming": the encoder's stream limit
# The compiled step's entry that the last `stream_step` / `stream_finish`
# replayed (None where it ran eagerly), for the benchmarks.
LAST_GRAPH = {"step": None, "finish": None}


@torch.inference_mode()
def stream_init(model, N: int, max_length: int, blank: int = 0,
                beam_size: int = 0):
    """A fresh streaming session state.

    ``max_length`` bounds the emitted tokens an utterance (the token
    buffer's width); ``blank`` must match the value passed to step and
    finish.  ``beam_size`` > 0 makes it a beam-search session (the same
    exactness contract against `beam_decode`; `stream_finish` then also
    returns the best-alignment scores).
    """
    if beam_size:
        return {"enc": model.encoder.stream_init(N),
                "dec_beam": beam_state_init(model, N, beam_size, max_length,
                                            blank)}
    return {"enc": model.encoder.stream_init(N),
            "dec": greedy_state_init(model, N, max_length, blank)}


def _drain(model, state, enc_state, out, p0, frame_bound,
           max_symbols_per_step, blank):
    if "dec_beam" in state:
        return {"enc": enc_state, "dec_beam": beam_drain(
            model, state["dec_beam"], out, p0, frame_bound,
            max_symbols_per_step=max_symbols_per_step, blank=blank)}
    return {"enc": enc_state, "dec": greedy_drain(
        model, state["dec"], out, p0, frame_bound,
        max_symbols_per_step=max_symbols_per_step, blank=blank)}


def _carry(enc_state):
    """The encoder's stream state as a flat tuple: m, then each block's
    ``ln`` and ``x``."""
    return (enc_state["m"], *(t for b in enc_state["blocks"]
                              for t in (b["ln"], b["x"])))


def _enc_state(flat):
    """`_carry`'s inverse."""
    rest = flat[1:]
    return {"m": flat[0], "blocks": tuple(
        {"ln": rest[i], "x": rest[i + 1]} for i in range(0, len(rest), 2))}


def encoder_step(model, finish: bool, with_xn: bool):
    """The chunk's encoder step as a `CompiledStep` (module docstring).

    ``step(*carry, feats (N, C, F)[, xn (N,) int32])`` in `stream_step`
    (``finish`` False), ``step(*carry, L (0-d int32)[, xn])`` in
    `stream_finish`, ``carry`` the flat `_carry` of the encoder's state;
    returns (*new carry, out (N, C, H) fp32, p0 0-d, bound (N,) or 0-d
    int32): frames at positions < bound are final."""
    encoder = model.encoder

    def fn(*args):
        k = 1 + 2 * len(encoder.conv_blocks)
        state, (x, *xn) = _enc_state(args[:k]), args[k:]
        if finish:
            new, out, p0 = encoder.stream_finish(state, x)
            bound = x
        else:
            new, out, p0 = encoder.stream(state, x, _NO_LIMIT)
            bound = (p0 + x.shape[1]).clamp(min=0)  # positions < bound are final
        if xn:
            bound = torch.minimum(xn[0], bound)
        return (*_carry(new), out, p0, bound)

    params = tuple((p.data_ptr(), p.dtype, tuple(p.shape))
                   for p in (*encoder.parameters(), *encoder.buffers()))
    return compiled_step(fn, key=("streaming.encoder_step", id(encoder),
                                  params, finish, with_xn))


def _encode(model, enc_state, x, xn, finish):
    """(new encoder state, out, p0, bound) of one chunk: x the features
    (N, C, F), or the stream's length L when ``finish``."""
    carry = _carry(enc_state)
    args = (*carry, x)
    if xn is not None:
        args += (torch.as_tensor(xn, dtype=torch.int32, device=x.device),)
    step = encoder_step(model, finish, xn is not None)
    outs = step(*args)
    LAST_GRAPH["finish" if finish else "step"] = step.entry
    new = outs[:len(carry)]
    if step.entry is not None:  # the graph's static buffers: clone them out
        new = tuple(t.clone() for t in new)
    return (_enc_state(new), *outs[len(carry):])


@torch.inference_mode()
def stream_step(model, state, feats_chunk, xn=None,
                max_symbols_per_step: int = 4, blank: int = 0):
    """Feed a chunk of raw feature frames (N, C, F); returns the new state.

    Encoder frames for stream positions [m - R, m + C - R) become
    available (R = `Encoder.lookahead`, m = frames fed before this chunk)
    and are decoded at once.  ``xn`` (N,) optionally caps each sample's
    decoding at a known valid length (pass the same tensor every call); by
    default every fed frame is decoded.
    """
    enc_state, out, p0, bound = _encode(model, state["enc"], feats_chunk, xn,
                                        finish=False)
    return _drain(model, state, enc_state, out, p0, bound,
                  max_symbols_per_step, blank)


@torch.inference_mode()
def stream_finish(model, state, xn=None, max_symbols_per_step: int = 4,
                  blank: int = 0):
    """End the stream: flush the encoder's lookahead, decode the tail, and
    return (tokens (N, max_length), lengths (N,), state); a beam session
    returns (tokens, lengths, scores, state).

    The returned state is terminal, for inspection or a checkpoint only:
    its encoder has consumed the flush frames, so a further `stream_step`
    or `stream_finish` on it decodes frames that are not in the stream.
    """
    enc_state, out, p0, bound = _encode(model, state["enc"],
                                        state["enc"]["m"], xn, finish=True)
    state = _drain(model, state, enc_state, out, p0, bound,
                   max_symbols_per_step, blank)
    if "dec_beam" in state:
        return (*beam_best(state["dec_beam"]), state)
    dec = state["dec"]
    return dec[6], dec[1], state
