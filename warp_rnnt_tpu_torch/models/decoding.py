"""Greedy RNN-T decoding, batched (counterpart of
`warp_rnnt_tpu/models/decoding.py`).

Standard greedy transducer search: at lattice cell (t, u) take the argmax
of the joint; a blank advances t, a label advances the predictor and
appends the token.  Every sample carries its own frame pointer t, and a
per-frame emission cap (``max_symbols_per_step``) bounds the loop.

JAX's ``lax.while_loop`` becomes a Python ``while`` on
``bool((t < frame_bound).any())``: one host read of the device an
iteration.  The condition is JAX's exactly, since an extra iteration is
not a no-op (it rewrites ``emitted_here`` and ``last_tok``).  Each
iteration adds one to ``LOOP_ITERATIONS[name]`` (one host read each), so a
benchmark reads what a CUDA graph or a device-side loop would save.

The port's modules hold their parameters, so the functions take the model
and no ``params``; the decode runs under ``torch.inference_mode()`` on the
model's device.
"""

from __future__ import annotations

import torch

# Loop iterations (each one host read), by decoder; `bench_decode` sets
# them to 0 before a decode and reads them after.
LOOP_ITERATIONS = {"greedy": 0, "beam": 0}


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
    and by the streaming session (`models/streaming.py`)."""
    max_length = dec[6].shape[1]
    l_iota = torch.arange(max_length, device=enc.device)[None, :]
    t, u, emitted_here, last_tok, pred_state, pred_out, tokens = dec
    # every sample advances t on each non-emitting step, so the loop ends
    # after at most C * max_symbols_per_step + max_length iterations
    while bool((t < frame_bound).any()):
        LOOP_ITERATIONS["greedy"] += 1
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
        last_tok = best
    return (t, u, emitted_here, last_tok, pred_state, pred_out, tokens)
