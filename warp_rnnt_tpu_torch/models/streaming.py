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

A chunk is compiled whole once per shape through `utils.compiled_step`,
as JAX jits `stream_step` whole (`chunk_step`): on the card one CUDA graph
holds the encoder's chunk step (`Encoder.stream`, or `Encoder.stream_finish`
and the frame bound after it), the drain's while node (`utils.device_loop`)
and, at the finish, `beam_best`; each call is one replay and one host read
(the loop's status, after the replay).  The graph is keyed by the model and
its parameters' addresses, the state's layout, whether ``xn`` is given,
the limit's kind (the constant `_NO_LIMIT` in `stream_step`, the stream's
length in `stream_finish`), ``max_symbols_per_step``, ``blank`` and the
loop's unroll; the chunk's shape keys the rest, so the ragged tail and the
flush have graphs of their own.  On the CPU it runs eagerly, the plain
version.

On the card the compiled chunk takes and gives the session's tensors as
one flat byte buffer (`pack`, each tensor on a 16-byte boundary;
`unpack` views the tensors in it): the graph packs the new state into its
static output, which the next chunk of that shape overwrites, whichever
session sends it, so the chunk clones it out in one launch and returns
views of that clone; every session's state is its own, and sessions of
one shape may interleave.  A state whose tensors are such views (the
state a compiled chunk returned) goes back in as that buffer, one copy
into the graph's static input; any other (`stream_init`'s, one built by
hand) is packed first, one ``cat``.  The eager chunk (the CPU, the card's
plain version) packs nothing: its state is the dict of its tensors.

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

import functools
import math

import torch

from warp_rnnt_tpu_torch.models.beam_search import (
    beam_best,
    beam_drain,
    beam_state_init,
)
from warp_rnnt_tpu_torch.models.decoding import (
    folds,
    greedy_drain,
    greedy_state_init,
)
from warp_rnnt_tpu_torch.ops import decode_step
from warp_rnnt_tpu_torch.utils import device_loop
from warp_rnnt_tpu_torch.utils.compiled_step import (
    compiled_step,
    module_key,
    runs_eagerly,
    tracing,
)

_NO_LIMIT = 2 ** 30  # "more frames are coming": the encoder's stream limit
# The compiled step's entry that the last `stream_step` / `stream_finish`
# replayed (None where it ran eagerly), for the benchmarks.
LAST_GRAPH = {"step": None, "finish": None}


_ALIGN = 16  # bytes: where each tensor of a packed state starts


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


def _leaves(state):
    """A session state's tensors, in order: the encoder's `_carry`, then
    the decoder's state."""
    return (*_carry(state["enc"]),
            *(state["dec_beam"] if "dec_beam" in state else state["dec"]))


def _spec(tensors):
    return tuple((t.shape, t.dtype) for t in tensors)


def _session(leaves, beam):
    """`_leaves`' inverse: the decoder's state is the last 7 tensors
    (greedy) or 9 (beam), the encoder's carry the rest."""
    k = len(leaves) - (9 if beam else 7)
    return {"enc": _enc_state(leaves[:k]),
            "dec_beam" if beam else "dec": tuple(leaves[k:])}


@functools.lru_cache(maxsize=64)
def _layout(spec):
    """(offset of each tensor of ``spec`` ((shape, dtype), ...) in its
    packed buffer, the buffer's bytes): in order, each on an `_ALIGN`
    boundary."""
    offsets, end = [], 0
    for shape, dtype in spec:
        offsets.append(end)
        end += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return tuple(offsets), end


def pack(tensors):
    """One flat uint8 buffer of ``tensors`` laid out by `_layout`: one
    ``cat`` (the gaps are views of one small zero tensor)."""
    offsets, end = _layout(_spec(tensors))
    pad = tensors[0].new_zeros((_ALIGN,), dtype=torch.uint8)
    parts = []
    for t, a, b in zip(tensors, offsets, (*offsets[1:], end)):
        parts.append(t.contiguous().view(-1).view(torch.uint8))
        if b - a > parts[-1].numel():
            parts.append(pad[:b - a - parts[-1].numel()])
    return torch.cat(parts)


@functools.lru_cache(maxsize=64)
def _views(spec):
    """[(dtype, shape, contiguous strides, offset in elements)] of each
    tensor of ``spec`` in its packed buffer."""
    out = []
    for (shape, dtype), o in zip(spec, _layout(spec)[0]):
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        out.append((dtype, shape, tuple(strides), o // dtype.itemsize))
    return out


def unpack(buf, spec):
    """The tensors of ``spec`` in `pack`'s buffer ``buf`` (its own storage,
    from its start), as views of it: one typed view of the buffer a
    dtype, then one strided view a tensor."""
    typed, out = {}, []
    for dtype, shape, strides, offset in _views(spec):
        whole = typed.get(dtype)
        if whole is None:
            whole = typed[dtype] = buf.view(dtype)
        out.append(whole.as_strided(shape, strides, offset))
    return tuple(out)


def _buffer(leaves, spec):
    """The flat buffer of ``leaves``: the storage they are views of, where
    they are `unpack`'s views of a whole buffer of layout ``spec`` (one
    storage of its size, each tensor contiguous at its offset), else a
    new buffer (`pack`)."""
    offsets, end = _layout(spec)
    storage = leaves[0].untyped_storage()
    at = storage.data_ptr()
    if storage.nbytes() == end and all(
            t.untyped_storage().data_ptr() == at
            and t.data_ptr() == at + o and t.is_contiguous()
            for t, o in zip(leaves, offsets)):
        return leaves[0].new_empty((0,), dtype=torch.uint8).set_(
            storage, 0, (end,), (1,))
    return pack(leaves)


def _results_spec(spec, beam):
    """The spec of a beam finish's (tokens, lengths, scores)."""
    (n, _), (b, _) = spec[-9], spec[-7]  # t (N,), tokens (N, B, L)
    return ((torch.Size((n[0], b[2])), torch.int32), (n, torch.int32),
            (n, torch.float32))


def chunk_step(model, spec, beam, finish, with_xn, max_symbols_per_step,
               blank):
    """A chunk compiled whole as a `CompiledStep` (module docstring).

    Where it replays a graph (`compiled_step.runs_eagerly` false):
    ``step(packed, feats (N, C, F)[, xn (N,) int32])`` in `stream_step`
    (``finish`` False), ``step(packed[, xn])`` in `stream_finish`,
    ``packed`` the session's buffer of layout ``spec``; it returns (the
    new state's buffer,), whose layout at the finish of a beam session
    adds (tokens, lengths, scores) (`_results_spec`).  Where it runs
    eagerly, the session's tensors take the buffer's place in the
    arguments and the results: nothing is packed."""
    encoder = model.encoder
    n = len(spec)

    def fn(*args):
        packed = tracing()  # traced only where the step captures a graph
        if packed:
            leaves, rest = unpack(args[0], spec), args[1:]
        else:
            leaves, rest = args[:n], args[n:]
        state = _session(leaves, beam)
        if finish:
            limit = state["enc"]["m"]
            new, out, p0 = encoder.stream_finish(state["enc"], limit)
            bound, xn = limit, rest
        else:
            (x, *xn) = rest
            new, out, p0 = encoder.stream(state["enc"], x, _NO_LIMIT)
            # positions < bound are final
            bound = (p0 + x.shape[1]).clamp(min=0)
        if xn:
            bound = torch.minimum(xn[0], bound)
        state = _drain(model, state, new, out, p0, bound,
                       max_symbols_per_step, blank)
        out = _leaves(state)
        if finish and beam:
            out += beam_best(state["dec_beam"])
        return (pack(out),) if packed else out

    return compiled_step(fn, key=(
        "streaming.chunk_step", id(model), module_key(model), spec, beam,
        finish, with_xn, max_symbols_per_step, blank, device_loop.UNROLL,
        folds(decode_step)))


def _chunk(model, state, finish, args, xn, max_symbols_per_step, blank):
    """One chunk (``args``: the features) or the finish through
    `chunk_step`: (the new state, the beam finish's results or ())."""
    beam = "dec_beam" in state
    leaves = _leaves(state)
    spec = _spec(leaves)
    if xn is not None:
        args += (torch.as_tensor(xn, dtype=torch.int32,
                                 device=leaves[0].device),)
    step = chunk_step(model, spec, beam, finish, xn is not None,
                      max_symbols_per_step, blank)
    if runs_eagerly(leaves[0].device):
        out = step(*leaves, *args)
    else:  # the graph's static buffer: cloned out, the state its views
        (buf,) = step(_buffer(leaves, spec), *args)
        out = unpack(buf.clone(), spec + (_results_spec(spec, beam)
                                          if finish and beam else ()))
    LAST_GRAPH["finish" if finish else "step"] = step.entry
    return _session(out[:len(spec)], beam), out[len(spec):]


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
    return _chunk(model, state, False, (feats_chunk,), xn,
                  max_symbols_per_step, blank)[0]


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
    state, best = _chunk(model, state, True, (), xn, max_symbols_per_step,
                         blank)
    if best:
        return (*best, state)
    dec = state["dec"]
    return dec[6], dec[1], state
