"""The plain RNN-T loss: costs and gradients of a padded batch.

Plain PyTorch, independent of the program: the (N, T, U) blank and label
lattices are gathered from the (N, T, U, V) log-probs, and the forward
(alpha) and backward (beta) variables are swept over the anti-diagonals
t + u = d of a skewed copy, one vector step a diagonal.  Every operation
runs in ``dtype``: float64 for the reference, a lower precision for the
control.

    alpha(0, 0) = 0
    alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
                            alpha(t, u-1) + emit(t, u-1))
    beta(xn, yn) = 0 (past the last frame's blank)
    beta(t, u)  = logaddexp(beta(t+1, u) + blank(t, u),
                            beta(t, u+1) + emit(t, u))
    cost = -beta(0, 0)
    d cost / d blank(t, u) = -exp(alpha(t, u) + blank(t, u) + beta(t+1, u) + cost)
    d cost / d emit(t, u)  = -exp(alpha(t, u) + emit(t, u) + beta(t, u+1) + cost)

The gradient with respect to the log-probs is these two at the blank and
at the next label of each valid cell, and zero everywhere else.
"""

from __future__ import annotations

import torch

NEG = float("-inf")


def gather(log_probs, labels, blank: int = 0, dtype=torch.float64):
    """(N, T, U, V) log-probs, (N, U-1) labels -> blank, emit (N, T, U) in
    ``dtype``; emit is -inf on the last row, which has no next label."""
    N, T, U, V = log_probs.shape
    blank_lp = log_probs[..., blank].to(dtype)
    idx = labels.long()[:, None, :, None].expand(N, T, U - 1, 1)
    emit = torch.gather(log_probs[:, :, :U - 1, :], 3, idx)[..., 0].to(dtype)
    pad = torch.full((N, T, 1), NEG, dtype=dtype, device=log_probs.device)
    return blank_lp, torch.cat([emit, pad], dim=2)


def _mask(blank_lp, emit, xn, yn):
    """-inf outside each utterance's lattice: blank where t >= xn or
    u > yn, emit where t >= xn or u >= yn."""
    N, T, U = blank_lp.shape
    dev = blank_lp.device
    t = torch.arange(T, device=dev)[None, :, None]
    u = torch.arange(U, device=dev)[None, None, :]
    xn = xn.long()[:, None, None]
    yn = yn.long()[:, None, None]
    blank_lp = blank_lp.masked_fill((t >= xn) | (u > yn), NEG)
    emit = emit.masked_fill((t >= xn) | (u >= yn), NEG)
    return blank_lp, emit


def _skew(x, D):
    """(N, T, U) -> (N, D, U) with out[:, d, u] = x[:, d - u, u], -inf
    where d - u lies outside [0, T)."""
    N, T, U = x.shape
    dev = x.device
    d = torch.arange(D, device=dev)[:, None]
    u = torch.arange(U, device=dev)[None, :]
    t = d - u
    ok = (t >= 0) & (t < T)
    out = x[:, t.clamp(0, T - 1), u.expand(D, U)]
    return out.masked_fill(~ok[None], NEG)


def _unskew(x, T):
    """(N, D, U) skewed -> (N, T, U)."""
    N, D, U = x.shape
    dev = x.device
    t = torch.arange(T, device=dev)[:, None]
    u = torch.arange(U, device=dev)[None, :]
    return x[:, t + u, u.expand(T, U)]


def _shift_u(x):
    """x[:, u - 1] along the last axis, -inf at u = 0."""
    return torch.cat([x.new_full(x[:, :1].shape, NEG), x[:, :-1]], dim=1)


def _alpha(bs, es, op):
    """The forward variables over the skewed lattice, ``op`` the semiring's
    sum (logaddexp; maximum for the best path)."""
    N, D, U = bs.shape
    alpha = torch.full((N, D, U), NEG, dtype=bs.dtype, device=bs.device)
    alpha[:, 0, 0] = 0
    for d in range(1, D):
        alpha[:, d] = op(alpha[:, d - 1] + bs[:, d - 1],
                         _shift_u(alpha[:, d - 1] + es[:, d - 1]))
    return alpha


def best_path(blank_lp, emit, xn, yn):
    """(N,) the log-prob of each utterance's best alignment, the last
    frame's blank included (the max-plus sweep), in the lattices' dtype."""
    N, T, U = blank_lp.shape
    blank_lp, emit = _mask(blank_lp, emit, xn, yn)
    D = T + U
    alpha = _alpha(_skew(blank_lp, D), _skew(emit, D), torch.maximum)
    n = torch.arange(N, device=blank_lp.device)
    return alpha[n, xn.long() + yn.long(), yn.long()]


def costs_and_grads(blank_lp, emit, xn, yn, grads: bool = True):
    """Costs (N,) and, with ``grads``, the gradients (N, T, U) with respect
    to blank and emit, in the dtype of ``blank_lp``."""
    N, T, U = blank_lp.shape
    dev = blank_lp.device
    blank_lp, emit = _mask(blank_lp, emit, xn, yn)
    D = T + U  # diagonals of the lattice with one row past the last frame
    bs, es = _skew(blank_lp, D), _skew(emit, D)
    alpha = _alpha(bs, es, torch.logaddexp)
    n = torch.arange(N, device=dev)
    last = xn.long() + yn.long()  # the skewed (xn, yn): past the last blank
    costs = -alpha[n, last, yn.long()]
    if not grads:
        return costs, None, None
    beta = torch.full((N, D + 1, U), NEG, dtype=blank_lp.dtype, device=dev)
    u_ar = torch.arange(U, device=dev)[None, :]
    start = u_ar == yn.long()[:, None]
    for d in range(D - 1, -1, -1):
        nxt = beta[:, d + 1]
        up = torch.cat([nxt[:, 1:], nxt.new_full((N, 1), NEG)], dim=1)
        step = torch.logaddexp(nxt + bs[:, d], up + es[:, d])
        beta[:, d] = torch.where(start & (last == d)[:, None],
                                 torch.zeros((), dtype=step.dtype,
                                             device=dev), step)
    nxt = beta[:, 1:D + 1]
    up = torch.cat([nxt[:, :, 1:], nxt.new_full((N, D, 1), NEG)], dim=2)
    c = costs[:, None, None]
    g_blank = -torch.exp(alpha + bs + nxt + c)
    g_emit = -torch.exp(alpha + es + up + c)
    return costs, _unskew(g_blank, T), _unskew(g_emit, T)


def loss(log_probs, labels, xn, yn, blank: int = 0, dtype=torch.float64,
         grads: bool = True):
    """Costs (N,) and the gathered gradients (N, T, U) of the padded
    log-probs, computed in ``dtype``."""
    b, e = gather(log_probs, labels, blank, dtype)
    return costs_and_grads(b, e, xn, yn, grads)


def dense(g_blank, g_emit, labels, V: int, blank: int = 0, dtype=None):
    """The (N, T, U, V) gradient with respect to the log-probs: ``g_blank``
    at the blank, ``g_emit`` at the next label, zero elsewhere."""
    N, T, U = g_blank.shape
    dtype = dtype or g_blank.dtype
    out = torch.zeros((N, T, U, V), dtype=dtype, device=g_blank.device)
    out[..., blank] = g_blank.to(dtype)
    ge = g_emit.to(dtype).clone()
    ge[:, :, U - 1] = 0
    lab = torch.cat([labels.long(), labels.new_full((N, 1), 1).long()], 1)
    out.scatter_add_(3, lab[:, None, :, None].expand(N, T, U, 1),
                     ge[..., None])
    return out


class Loss(torch.autograd.Function):
    """``Loss.apply(log_probs, labels, xn, yn, dtype, blank)``: the costs
    (N,), computed in ``dtype`` and returned in the log-probs' dtype, with
    the dense gradient for backward."""

    @staticmethod
    def forward(ctx, lp, labels, xn, yn, dtype, blank):
        costs, gb, ge = loss(lp, labels, xn, yn, blank, dtype)
        ctx.save_for_backward(dense(gb, ge, labels, lp.shape[-1], blank,
                                    lp.dtype))
        return costs.to(lp.dtype)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return g[:, None, None, None] * d, None, None, None, None, None


def dense_grad_error(grad, labels, g_blank, g_emit, blank: int = 0,
                     block: int = 4):
    """The largest |grad - reference| over the whole (N, T, U, V) ``grad``,
    where the reference is ``g_blank`` at the blank, ``g_emit`` at the next
    label and zero elsewhere; compared in float64, ``block`` utterances at
    a time."""
    N, T, U, V = grad.shape
    worst = 0.0
    for i in range(0, N, block):
        d = grad[i:i + block].double()
        d[..., blank] -= g_blank[i:i + block].double()
        lab = torch.cat([labels[i:i + block].long(),
                         labels.new_full((d.shape[0], 1), 1).long()], dim=1)
        ge = g_emit[i:i + block].double().clone()
        ge[:, :, U - 1] = 0.0
        d.scatter_add_(3, lab[:, None, :, None].expand(-1, T, U, 1),
                       -ge[..., None])
        m = float(d.abs().max())
        worst = max(worst, m if m == m else float("inf"))  # NaN reads inf
    return worst
