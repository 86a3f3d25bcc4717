"""Viterbi forced alignment over the RNN-T lattice (counterpart of
`warp_rnnt_tpu/functional/alignment.py`).

Given log-probs and a label sequence, find the most probable monotonic path
through the (T, U) lattice, i.e. the frame at which each label is emitted.
The max-plus analogue of the loss's column recurrence

    s[t, u] = max(s[t-1, u] + blank[t-1, u],  s[t, u-1] + emit[t, u-1])

is a max-plus linear recurrence along t.  A Python loop walks the U
columns; within a column a doubling (Hillis-Steele) scan over T solves it,
as `scan_impl` does in log space, with the combine

    (m1, b1) . (m2, b2) = (m1 + m2, max(b2, b1 + m2)).

Each s[t, u] is a max of sums of a few log-probs, so it carries no
cancellation: a cumsum/cummax rewrite would subtract prefix sums of ~T
terms and lose ~1e-3 at T=400, enough to flip the backtrace's
``via_emit >= via_blank`` test.  The backtrace is a fixed trip of T + U
steps over per-sample (t, u); finished samples idle.  Plain torch on the
device of the inputs: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.functional.loss import _gather_blank_emit
from warp_rnnt_tpu_torch.utils.lse import NEG_INF


def _maxrec(m, b):
    """Solve a[t] = max(a[t-1] + m[t], b[t]) along the last axis.

    Doubling scan: at step k every position combines with the one k to its
    left; positions with no left neighbour combine with the identity
    (0, -inf), which leaves them unchanged.
    """
    T = m.shape[-1]
    k = 1
    while k < T:
        lead = m.shape[:-1] + (k,)
        ms = torch.cat([m.new_zeros(lead), m[..., :-k]], dim=-1)
        bs = torch.cat([b.new_full(lead, NEG_INF), b[..., :-k]], dim=-1)
        m, b = ms + m, torch.maximum(b, bs + m)
        k *= 2
    return b


def _viterbi_scores(blank_lp, emit_lp, xn, yn):
    """Max-plus forward scores (N, T, U); the column scan of `scan_impl`."""
    N, T, U = blank_lp.shape
    t_iota = torch.arange(T, device=blank_lp.device)
    valid_t = t_iota[None, :] < xn[:, None]
    seed = torch.full((N, T), NEG_INF, dtype=blank_lp.dtype,
                      device=blank_lp.device)
    seed[:, 0] = 0.0
    zeros = blank_lp.new_zeros((N, 1))
    s_prev = None
    cols = []
    for u in range(U):
        if u == 0:
            b = seed
        else:
            emit_ok = ((u - 1) < yn)[:, None] & valid_t
            b = torch.where(emit_ok, s_prev + emit_lp[:, :, u - 1], NEG_INF)
        m = torch.cat([zeros, blank_lp[:, :-1, u]], dim=1)
        s_prev = _maxrec(m, b)
        cols.append(s_prev)
    return torch.stack(cols, dim=2)


def rnnt_alignment(log_probs, labels, frames_lengths, labels_lengths,
                   blank: int = 0):
    """Viterbi alignment of ``labels`` to frames.

    Args:
      log_probs: (N, T, U, V) log-softmax outputs (U = max(yn) + 1), or a
        pre-gathered (N, T, U, 2) lattice with ``blank=-1``.
      labels: (N, U-1) int32 (unused when ``blank=-1``).
      frames_lengths, labels_lengths: (N,) int32.
      blank: blank index, or -1 for pre-gathered inputs.

    Returns:
      scores: (N,) fp32, the log-probability of the best path (<= -loss:
        the Viterbi path is one term of the full-sum likelihood).
      label_frames: (N, U-1) int32, the frame at which label u is emitted
        on the best path; -1 for u >= yn (padding).
    """
    if blank == -1:
        g = log_probs
    else:
        g = _gather_blank_emit(log_probs, labels, blank)
    blank_lp = g[..., 0].float()
    emit_lp = g[..., 1].float()

    N, T, U = blank_lp.shape
    dev = blank_lp.device
    xn = torch.as_tensor(frames_lengths, dtype=torch.int64, device=dev)
    yn = torch.as_tensor(labels_lengths, dtype=torch.int64, device=dev)

    s = _viterbi_scores(blank_lp, emit_lp, xn, yn)
    n_iota = torch.arange(N, device=dev)
    scores = s[n_iota, xn - 1, yn] + blank_lp[n_iota, xn - 1, yn]

    # Backtrace: at (t, u) the path came vertically (label u emitted at
    # frame t) iff s[t, u-1] + emit[t, u-1] >= s[t-1, u] + blank[t-1, u].
    # s_pad[n, a, b] == s[n, a-1, b-1]; blank_pad shifts t, emit_pad u.
    s_pad = torch.nn.functional.pad(s, (1, 0, 1, 0), value=NEG_INF)
    blank_pad = torch.nn.functional.pad(blank_lp, (0, 0, 1, 0), value=NEG_INF)
    emit_pad = torch.nn.functional.pad(emit_lp, (1, 0), value=NEG_INF)
    L = max(U - 1, 1)
    l_iota = torch.arange(L, device=dev)[None, :]
    frames = torch.full((N, L), -1, dtype=torch.int64, device=dev)
    t, u = xn - 1, yn
    for _ in range(T + U):
        done = (t <= 0) & (u <= 0)
        via_emit = s_pad[n_iota, t + 1, u] + emit_pad[n_iota, t, u]
        via_blank = s_pad[n_iota, t, u + 1] + blank_pad[n_iota, t, u]
        take_emit = (~done) & (u > 0) & ((t == 0) | (via_emit >= via_blank))
        frames = torch.where(take_emit[:, None] & (l_iota == (u - 1)[:, None]),
                             t[:, None], frames)
        t = torch.where(done | take_emit, t, t - 1)
        u = torch.where(take_emit, u - 1, u)
    return scores, frames[:, : U - 1].to(torch.int32)

