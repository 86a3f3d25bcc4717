"""Plain-torch RNN-T forward-backward, column-scan formulation (counterpart
of `warp_rnnt_tpu/functional/scan_impl.py`; the ``impl="scan"`` path).

Each lattice column u is computed in one shot from column u-1 by solving the
in-column dependency

    alpha[t, u] = LSE(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] + emit[t, u-1])

as the log-space first-order linear recurrence

    a[t] = LSE(a[t-1] + m[t], b[t]),   m[t] = blank[t-1, u],
                                       b[t] = alpha[t, u-1] + emit[t, u-1]

A Python loop walks the U columns; within a column a doubling
(Hillis-Steele) scan over T replaces JAX's `lax.associative_scan`, so the
sequential depth is U * ceil(log2 T) tensor steps.  All arithmetic is fp32.
Invalid cells are exactly -inf and every combine is -inf-safe.

Inputs are gathered lattices: `blank_lp[n, t, u] = log P(blank | t, u)` and
`emit_lp[n, t, u] = log P(y_{u+1} | t, u)`, both (N, T, U) with U = max(yn)+1,
on any device.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.utils.lse import NEG_INF, logrec_combine


def _linrec(m, b):
    """Solve a[t] = LSE(a[t-1] + m[t], b[t]) along the last axis.

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
        m, b = logrec_combine((ms, bs), (m, b))
        k *= 2
    return b


def compute_alphas(blank_lp, emit_lp, xn, yn):
    """Forward lattice scores (N, T, U) fp32; -inf at columns u > yn."""
    N, T, U = blank_lp.shape
    t_iota = torch.arange(T, device=blank_lp.device)
    valid_t = t_iota[None, :] < xn[:, None]  # (N, T)
    seed = torch.full((N, T), NEG_INF, dtype=blank_lp.dtype,
                      device=blank_lp.device)
    seed[:, 0] = 0.0
    zeros = blank_lp.new_zeros((N, 1))

    alpha_prev = None
    cols = []
    for u in range(U):
        if u == 0:
            b = seed
        else:
            emit_ok = ((u - 1) < yn)[:, None] & valid_t
            b = torch.where(emit_ok, alpha_prev + emit_lp[:, :, u - 1], NEG_INF)
        # m[t] = blank[t-1, u]; m[0] is never consumed by the scan.
        m = torch.cat([zeros, blank_lp[:, :-1, u]], dim=1)
        alpha_prev = _linrec(m, b)
        cols.append(alpha_prev)
    return torch.stack(cols, dim=2)


def compute_betas(blank_lp, emit_lp, xn, yn):
    """Backward lattice scores (N, T, U) fp32.

    beta[n, t, u] includes the emission out of (t, u); the terminal cell
    (xn-1, yn) seeds with its blank log-prob.  Invalid cells are exactly -inf.
    """
    N, T, U = blank_lp.shape
    t_iota = torch.arange(T, device=blank_lp.device)
    valid_t = t_iota[None, :] < xn[:, None]
    terminal_t = t_iota[None, :] == (xn[:, None] - 1)

    beta_next = torch.full((N, T), NEG_INF, dtype=blank_lp.dtype,
                           device=blank_lp.device)
    cols = [None] * U
    for u in range(U - 1, -1, -1):
        blank_col = blank_lp[:, :, u]
        emit_ok = (u < yn)[:, None] & valid_t
        b = torch.where(
            terminal_t & (u == yn)[:, None],
            blank_col,
            torch.where(emit_ok, emit_lp[:, :, u] + beta_next, NEG_INF),
        )
        # beta[t] = LSE(beta[t+1] + blank[t], b[t]): flip t, scan, flip back.
        beta_next = torch.flip(
            _linrec(torch.flip(blank_col, (1,)), torch.flip(b, (1,))), (1,)
        )
        cols[u] = beta_next
    return torch.stack(cols, dim=2)


def forward_backward(blank_lp, emit_lp, xn, yn, fastemit_lambda=0.0):
    """Costs (N,), grad_blank, grad_emit, alphas, betas (all (N, T, U) fp32).

    Gradient and canary semantics are those of
    `warp_rnnt_tpu_torch.functional.postprocess.costs_and_grads`.
    """
    from warp_rnnt_tpu_torch.functional.postprocess import costs_and_grads

    blank_lp = blank_lp.float()
    emit_lp = emit_lp.float()
    alphas = compute_alphas(blank_lp, emit_lp, xn, yn)
    betas = compute_betas(blank_lp, emit_lp, xn, yn)
    costs, grad_blank, grad_emit = costs_and_grads(
        blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda
    )
    return costs, grad_blank, grad_emit, alphas, betas


def forward_backward_gathered(xs_gathered, xn, yn, fastemit_lambda=0.0,
                              dtype=None):
    """`forward_backward` on the gathered (N, T, U, 2) lattice: (costs,
    grads (N, T, U, 2) in ``dtype`` (default the lattice's), alphas,
    betas)."""
    costs, grad_blank, grad_emit, alphas, betas = forward_backward(
        xs_gathered[..., 0], xs_gathered[..., 1], xn, yn, fastemit_lambda)
    grads = torch.stack([grad_blank, grad_emit], dim=-1)
    return costs, grads.to(dtype or xs_gathered.dtype), alphas, betas


def costs_only(blank_lp, emit_lp, xn, yn):
    """Inference path: one backward sweep, no gradients."""
    betas = compute_betas(blank_lp.float(), emit_lp.float(), xn, yn)
    return -betas[:, 0, 0]
