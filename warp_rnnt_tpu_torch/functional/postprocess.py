"""Cost/gradient post-processing from lattice scores (counterpart of
`warp_rnnt_tpu/functional/postprocess.py`).

Both backends (the plain scan and the CUDA lattice kernels) produce alphas
and betas.  This elementwise torch code is the plain version of the
epilogue after the sweep: the scan runs it, and on the card
`ops.cuda_impl.epilogue` runs the same operations in one kernel
(`epilogue_plain` is this code written to the kernel's outputs).

Semantics:
  * blank grad  -exp(alpha + blank_lp + beta[t+1,u] - ll), beta dropped at the
    terminal cell (xn-1, yn); zero at (t = xn-1, u < yn) and outside the
    valid region.
  * label grad  -(1+lambda) * exp(alpha + emit_lp + beta[t,u+1] - ll).
  * consistency: ll_f = alpha[xn-1, yn] + blank_lp[xn-1, yn] vs ll_b =
    beta[0,0]; if |ll_f-ll_b|/|max(ll_f,ll_b)| > 0.001 the sample's grads are
    zeroed and its cost becomes -(ll_f+ll_b)/2.
"""

from __future__ import annotations

import os
import warnings

import torch

from warp_rnnt_tpu_torch.utils import compiled_step
from warp_rnnt_tpu_torch.utils.lse import NEG_INF


def _canary_debug_enabled() -> bool:
    """Opt-in warning for the forward/backward consistency check
    (``WARP_RNNT_DEBUG=1``; costs one host sync per call when set)."""
    return os.environ.get("WARP_RNNT_DEBUG", "") not in ("", "0", "false", "False")


def loglik_forward_backward(blank_lp, alphas, betas, xn, yn):
    """Terminal forward and backward log-likelihood per sample.

    Out-of-range lengths index as JAX indexes: a negative frame index wraps
    once, then indices clamp to the lattice."""
    N, T, U = blank_lp.shape
    n_iota = torch.arange(N, device=blank_lp.device)
    t_last = xn.long() - 1
    t_last = torch.where(t_last < 0, t_last + T, t_last).clamp(0, T - 1)
    u_last = yn.long().clamp(0, U - 1)
    ll_b = betas[:, 0, 0]
    ll_f = alphas[n_iota, t_last, u_last] + blank_lp[n_iota, t_last, u_last]
    return ll_f, ll_b


def mismatch_mask(blank_lp, alphas, betas, xn, yn):
    """Boolean (N,) mask of samples whose forward/backward log-likelihoods
    disagree by >0.1% -- the numerical canary.  Flagged samples get zero
    gradients and an averaged cost."""
    ll_f, ll_b = loglik_forward_backward(blank_lp, alphas, betas, xn, yn)
    ratio = (ll_f - ll_b).abs() / torch.maximum(ll_f, ll_b).abs()
    return ratio > 0.001


def _warn(bad, ll_f, ll_b, stacklevel):
    warnings.warn(
        "warp_rnnt_tpu_torch WARNING: forward/backward mismatch - grads"
        " zeroed and cost averaged for flagged samples."
        f" mask={bad.tolist()} ll_forward={ll_f.tolist()}"
        f" ll_backward={ll_b.tolist()}",
        RuntimeWarning,
        stacklevel=stacklevel + 1,
    )


def _warn_after_replay(bad, ll_f, ll_b):
    if _canary_debug_enabled() and bool(bad.any()):
        _warn(bad, ll_f, ll_b, stacklevel=5)  # the compiled step's caller


def warn_mismatch(bad, blank_lp, alphas, betas, xn, yn):
    """With ``WARP_RNNT_DEBUG=1``, warn when the canary's mask ``bad`` has
    tripped (one host sync), naming the samples' log-likelihoods.

    While a compiled step traces its call (`utils.compiled_step`), which a
    host read would break, the log-likelihoods are computed on the device
    and the read and warning run after each replay of the graph: a
    compiled call that trips the canary warns as an eager call does."""
    if not _canary_debug_enabled():
        return
    if compiled_step.tracing():
        ll_f, ll_b = loglik_forward_backward(blank_lp, alphas, betas, xn, yn)
        compiled_step.after_replay(lambda: _warn_after_replay(bad, ll_f, ll_b))
        return
    if bool(bad.any()):
        ll_f, ll_b = loglik_forward_backward(blank_lp, alphas, betas, xn, yn)
        _warn(bad, ll_f, ll_b, stacklevel=3)


def costs_and_grads(blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda):
    """All inputs (N, T, U) fp32 (alphas/betas may hold a large negative
    sentinel instead of -inf at invalid cells).  Returns
    (costs (N,), grad_blank (N,T,U), grad_emit (N,T,U))."""
    costs, grad_blank, grad_emit, bad = costs_grads_mask(
        blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda)
    warn_mismatch(bad, blank_lp, alphas, betas, xn, yn)
    return costs, grad_blank, grad_emit


def costs_grads_mask(blank_lp, emit_lp, alphas, betas, xn, yn,
                     fastemit_lambda):
    """`costs_and_grads` without the warning: (costs, grad_blank,
    grad_emit, the canary's mask)."""
    N, T, U = blank_lp.shape
    device = blank_lp.device

    ll_f, ll_b = loglik_forward_backward(blank_lp, alphas, betas, xn, yn)
    ratio = (ll_f - ll_b).abs() / torch.maximum(ll_f, ll_b).abs()
    bad = ratio > 0.001
    costs = torch.where(bad, -(ll_f + ll_b) * 0.5, -ll_b)

    t_iota = torch.arange(T, device=device)[None, :, None]
    u_iota = torch.arange(U, device=device)[None, None, :]
    xn_b = xn[:, None, None]
    yn_b = yn[:, None, None]
    terminal = (t_iota == xn_b - 1) & (u_iota == yn_b)

    ll = ll_b[:, None, None]
    beta_t1 = torch.cat(
        [betas[:, 1:, :], betas.new_full((N, 1, U), NEG_INF)], dim=1
    )
    beta_u1 = torch.cat(
        [betas[:, :, 1:], betas.new_full((N, T, 1), NEG_INF)], dim=2
    )

    occ_blank = alphas + blank_lp + torch.where(terminal, 0.0, beta_t1) - ll
    grad_blank = torch.where(
        (t_iota < xn_b) & (u_iota <= yn_b), -torch.exp(occ_blank), 0.0
    )

    occ_emit = alphas + emit_lp + beta_u1 - ll
    grad_emit = torch.where(
        (t_iota < xn_b) & (u_iota < yn_b),
        -(1.0 + fastemit_lambda) * torch.exp(occ_emit),
        0.0,
    )

    keep = torch.where(bad, 0.0, 1.0)[:, None, None]
    return costs, grad_blank * keep, grad_emit * keep, bad
