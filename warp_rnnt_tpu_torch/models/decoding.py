"""Greedy RNN-T decoding, batched (counterpart of
`warp_rnnt_tpu/models/decoding.py`).

Standard greedy transducer search: at lattice cell (t, u) take the argmax
of the joint; a blank advances t, a label advances the predictor and
appends the token.  Every sample carries its own frame pointer t, and a
per-frame emission cap (``max_symbols_per_step``) bounds the loop.

JAX's ``lax.while_loop`` becomes `utils.device_loop.while_loop` with
JAX's ``cond`` and ``body``: on the card, rounds of masked steps captured
once as the body of one CUDA graph conditional while node, one launch a
drain and one host read of the loop's flag after it; on the CPU the same
steps run eagerly, a host read a round.  The mask is JAX's ``cond``
itself, so a step past JAX's stopping point leaves the whole state bit
for bit (it would otherwise rewrite ``emitted_here`` and ``last_tok``).
Where the step runs on `ops.decode_step` (`folds`), the loop is folded
(``folded=True``): `decode_gru_greedy` computes that ``cond`` from the
step's inputs, writes ``emitted_here`` and ``last_tok`` (and the fields
it leaves anyway) through where it is false and counts the step, so a
step is the joint's three launches and the GRU's one, with no mask
kernel of the loop's between them.  Any other ``ops``
(`decode_step.PLAIN`, the card checks' recorders and yardsticks, the
first kernels) runs the loop's own mask, as before.  A drain adds
JAX's trip count, read from the loop's device counter, to
``LOOP_ITERATIONS[name]``, and its host reads to ``HOST_READS[name]``.

A graph is keyed by the shapes of the loop's inputs, and the encoder
frames are one of them, so a one-shot decode of each utterance length
would capture a graph of its own.  `run_drain` pads the frames' axis to
the next power of two by repeating the last frame (`pad_frames`): a
frame is read at ``clamp(t - p0, 0, C - 1)``, so every read gives the
frame it gave before, bit for bit, and the trip count, which reads only
t and the bounds, is unchanged.  Lengths 257 to 512 share one graph.

The step's loop invariants are lifted out of the loop, as XLA's
loop-invariant code motion lifts them out of JAX's while body:
`decode_consts` casts the joint's weights and biases to its compute dtype
and builds the GRU's recurrent bias, and `run_drain` hands them to the
loop as consts.  They are made once a model and kept while the parameters
they read keep their addresses, dtypes, shapes and version counters (an
in-place update through the parameter bumps its version); whatever writes
the weights without bumping them (a CUDA graph's replay of
`transducer.compiled_train_step`, a checkpoint's restore, a write through
``.data``) calls `forget_decode_consts`.  The step itself is
`ops.decode_step` (a drain's ``ops``): on a CUDA tensor the joint and its
argmax are one `decode_joint` call (three kernels) and the
GRU cell with greedy's masked update one `decode_gru_greedy` launch; on a
CPU tensor their plain versions, the torch code of the step as before.
``ops=decode_step.PLAIN`` runs the plain versions on any device: the card
checks' reference decode (`benchmarks/decode_step_cases.py`).

The port's modules hold their parameters, so the functions take the model
and no ``params``; the decode runs under ``torch.inference_mode()`` on the
model's device.

`compiled_greedy_decode` is `greedy_decode` compiled once per shape
(`utils.compiled_step`), as JAX's benchmark jits `greedy_decode` whole: on
the card the first call of a shape captures the encoder, the state's
init, the step's invariants and the drain's while node into one CUDA
graph, and each call is one replay and one host read (the loop's status,
after the replay).  While a compiled step is traced, `decode_consts`
makes the casts inside the graph, as JAX's jitted function does, so a
replay reads the weights as they stand (an in-place update, a compiled
train step's replay, is seen), and the drains leave the counters alone:
the warm-up's drain is the compile's, and each replay adds its own trip
count and read.  Its outputs are the graph's static buffers (valid until
the next call of that shape).  `greedy_decode` stays the eager entry: it
captures no graph per utterance shape.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from warp_rnnt_tpu_torch.ops import decode_step
from warp_rnnt_tpu_torch.ops.decode_step import frame_at  # noqa: F401
from warp_rnnt_tpu_torch.utils import device_loop
from warp_rnnt_tpu_torch.utils.compiled_step import (
    compiled_step,
    module_key,
    tracing,
)
from warp_rnnt_tpu_torch.utils.device_loop import while_loop

# Loop iterations (JAX's trip count) and the host's reads of the loop's
# flag, by decoder; `bench_decode` sets them to 0 before a decode and reads
# them after.  LAST_GRAPH: the device loop's graph entry of the decoder's
# last drain (None where it ran eagerly), for the benchmarks.
LOOP_ITERATIONS = {"greedy": 0, "beam": 0}
HOST_READS = {"greedy": 0, "beam": 0}
LAST_GRAPH = {"greedy": None, "beam": None}
COMPILED = "decoding.compiled_greedy_decode"  # its graphs' key name
# decode_consts' cache: {model: (key, DecodeConsts)}
_CONSTS = weakref.WeakKeyDictionary()


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


class DecodeConsts(NamedTuple):
    """The decode step's loop invariants, made once a drain by
    `decode_consts`: ``tensors`` go to the loop as consts, the rest is the
    step's static shape."""

    # w_pre (F_in, H), b_pre (H,), w_out (H, V), b_out (V,) in the joint's
    # compute dtype, the weights in Flax's (in, out) layout, contiguous;
    # b_hh (3 H', ) fp32, torch's recurrent bias of the Flax GRU
    tensors: tuple
    hidden: int  # the joint's width H
    vocab: int
    mode: str  # the joint's "add" or "concat"
    dtype: torch.dtype  # the joint's compute dtype


def _const_params(model):
    j = model.joint
    return (j.pre.weight, j.pre.bias, j.out.weight, j.out.bias,
            model.predictor.bias_hn)


def _consts_key(model, params):
    j = model.joint
    return (j.compute_dtype, j.mode, torch.is_inference_mode_enabled(),
            torch.is_grad_enabled(),
            tuple((p.data_ptr(), p.dtype, tuple(p.shape), p._version)
                  for p in params))


def decode_consts(model):
    """The step's loop invariants of a `Transducer` (`DecodeConsts`): the
    casts the joint's `_dense` made and the recurrent bias the predictor
    built each step, made once and kept for the next drain while the
    parameters they read keep their addresses, dtypes, shapes and
    versions (module docstring; parameters that are inference tensors
    have no version and are read anew each call, as they are while a
    compiled step is traced).  The same values, so the plain step on them
    gives the state it gave before, bit for bit."""
    params = _const_params(model)
    if tracing() or any(p.is_inference() for p in params):
        return _make_consts(model)
    key = _consts_key(model, params)
    hit = _CONSTS.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    dc = _make_consts(model)
    _CONSTS[model] = (key, dc)
    return dc


def forget_decode_consts(model):
    """Drop `decode_consts`' kept invariants of ``model``: for whatever
    writes the weights without bumping their version counters."""
    _CONSTS.pop(model, None)


def _make_consts(model):
    j = model.joint
    cd = j.compute_dtype
    tensors = (j.pre.weight.t().contiguous().to(cd), j.pre.bias.to(cd),
               j.out.weight.t().contiguous().to(cd), j.out.bias.to(cd),
               model.predictor.recurrent_bias())
    return DecodeConsts(tensors, j.pre.out_features, j.out.out_features,
                        j.mode, cd)


def gru_params(model):
    """The GRU's fp32 parameters the step reads in place: (embedding,
    weight_ih, weight_hh, bias_ih)."""
    p = model.predictor
    return p.embed.weight, p.weight_ih, p.weight_hh, p.bias_ih


def first_output(model, N, ops=decode_step):
    """The predictor's output after <sos> from the zero state, for N rows:
    the GRU cell on the zero embedding, through ``ops.decode_gru``."""
    h0 = model.predictor_init(N)
    sos = torch.full((N,), -1, dtype=torch.int32, device=h0.device)
    every = torch.ones((N,), dtype=torch.bool, device=h0.device)
    return ops.decode_gru(sos, h0, h0, every, *gru_params(model),
                          model.predictor.recurrent_bias())[1]


def folds(ops):
    """True where a drain on ``ops`` folds the loop's mask and count into
    the step's kernels: ``ops`` is `ops.decode_step` on its own library
    (`decode_step.folds`)."""
    return ops is decode_step and decode_step.folds()


def run_drain(name, model, body, state, enc, p0, frame_bound,
              max_iterations, static, step_consts=(), folded=False):
    """Run decoder ``name``'s ``body`` while a sample has frames left, on
    `while_loop` (``folded``: a body that masks and counts its own steps),
    and add its trip count and host reads to the counters (after each
    replay where a compiled step captured it; nothing while one is
    traced).  The loop's inputs are (`pad_frames(enc)`, frame_bound (N,)
    int32, p0 0-d int32, *``step_consts``); its graphs are keyed by
    ``name``, the model (the object and its parameters' addresses, dtypes
    and shapes: what the body closes over), ``folded`` and the ``static``
    arguments the body closes over (its ``ops`` among them)."""
    dev = enc.device
    consts = (pad_frames(enc),
              _int32(frame_bound, dev).expand(enc.shape[0]).contiguous(),
              _int32(p0, dev), *step_consts)

    def record(stats):
        if tracing():
            return
        LOOP_ITERATIONS[name] += stats.iterations
        HOST_READS[name] += stats.host_reads
        LAST_GRAPH[name] = stats.graph

    return while_loop(_frames_left, body, state, consts,
                      max_iterations=max_iterations,
                      key=(name, id(model), module_key(model), folded,
                           *static),
                      folded=folded, on_read=record)[0]


def _int32(x, dev):
    """``x`` as an int32 tensor on ``dev``: a Python int by a fill on the
    device (no copy from the host, which a capture cannot hold)."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int32, device=dev)
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


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


def compiled_key(name, model, *static):
    """The key of compiled decoder ``name`` (`compiled_greedy_decode`,
    `beam_search.compiled_beam_decode`): the model (the object, its
    parameters' and buffers' addresses, dtypes and shapes), the
    ``static`` arguments, the loop's unroll and whether it folds; the
    compiled step adds the inputs' shapes."""
    return (name, id(model), module_key(model), *static, device_loop.UNROLL,
            folds(decode_step))


def compiled_greedy(model, max_length: int, max_symbols_per_step: int = 4,
                    blank: int = 0):
    """`greedy_decode` of these arguments as a `CompiledStep`
    ``step(feats, xn (N,) int32) -> (tokens, lengths)``."""
    return compiled_step(
        lambda f, n: greedy_decode(model, f, n, max_length,
                                   max_symbols_per_step, blank),
        key=compiled_key(COMPILED, model, max_length, max_symbols_per_step,
                         blank))


@torch.inference_mode()
def compiled_greedy_decode(model, feats, xn, max_length: int,
                           max_symbols_per_step: int = 4, blank: int = 0):
    """`greedy_decode` compiled once per shape (module docstring): the
    same arguments and results, the results the graph's static buffers on
    the card."""
    xn = torch.as_tensor(xn, dtype=torch.int32, device=feats.device)
    return compiled_greedy(model, max_length, max_symbols_per_step,
                           blank)(feats, xn)


@torch.inference_mode()
def greedy_state_init(model, N, max_length: int, blank: int = 0, *,
                      ops=decode_step):
    """Fresh greedy decode state: (t, u, emitted_here, last_tok,
    pred_state, pred_out, tokens); the predictor's first step runs on
    ``ops`` (`first_output`)."""
    pred_state = model.predictor_init(N)
    dev = pred_state.device
    sos = torch.full((N,), -1, dtype=torch.int32, device=dev)
    pred_out = first_output(model, N, ops)

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
                 max_symbols_per_step: int = 4, blank: int = 0, *,
                 ops=decode_step):
    """Advance a greedy decode state over the available encoder frames.

    ``enc`` (N, C, H) holds frames for stream positions [p0, p0 + C); each
    sample consumes frames while its t < frame_bound (per sample, clipped
    by the caller to what enc covers).  Used by the one-shot
    `greedy_decode` (enc = the whole utterance, p0 = 0, frame_bound = xn)
    and by the streaming session (`models/streaming.py`).  The step runs
    on ``ops`` (`ops.decode_step`, or `decode_step.PLAIN`).

    Each iteration of an active sample emits or advances t, so a sample
    takes at most C frame steps and min(C * max_symbols_per_step,
    max_length) emissions: the loop's bound.  On `ops.decode_step` the
    loop is folded (`folds`; module docstring)."""
    C = enc.shape[1]
    max_length = dec[6].shape[1]
    dc = decode_consts(model)
    gru = gru_params(model)

    def body(state, consts, count=None):
        # count: the loop's, where the GRU folds in its mask and count
        enc, frame_bound, p0, w_pre, b_pre, w_out, b_out, b_hh = consts
        t, u, emitted_here, last_tok, pred_state, pred_out, tokens = state
        best = ops.decode_joint(enc, t, p0, pred_out, w_pre, b_pre, w_out,
                                b_out, dc.mode, blank)  # (N,) int32
        args = (best, t, u, emitted_here, frame_bound, tokens, pred_state,
                pred_out, *gru, b_hh, blank, max_symbols_per_step)
        if count is None:
            t, u, emitted_here, tokens, pred_state, pred_out = (
                ops.decode_gru_greedy(*args))
            return (t, u, emitted_here, best, pred_state, pred_out, tokens)
        (t, u, emitted_here, tokens, pred_state, pred_out, last_tok,
         count) = ops.decode_gru_greedy(*args, last_tok, count)
        return (t, u, emitted_here, last_tok, pred_state, pred_out,
                tokens), count

    return run_drain("greedy", model, body, dec, enc, p0, frame_bound,
                     C + min(C * max_symbols_per_step, max_length),
                     (blank, max_symbols_per_step, ops.__name__), dc.tensors,
                     folds(ops))
