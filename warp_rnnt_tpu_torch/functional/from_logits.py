"""RNN-T loss on raw joint logits, log_softmax folded into the loss
(counterpart of `warp_rnnt_tpu/functional/from_logits.py`).

  forward:  logZ = logsumexp over V, and the blank/label lattice gathered
            from the logits minus logZ; the (N, T, U, V) log-probs are
            never formed.  Then the lattice sweep (`_forward_backward`, or
            `_costs_only` when no gradient is needed, chosen before
            `Function.apply`).
  backward: the analytic gradient through the folded softmax,

      d cost / d logits[v] = ct * (sparse[v] - softmax[v] * (g_blank + g_emit))

            with ``sparse`` the two-nonzero occupancy gradient (g_blank at
            the blank, g_emit at the label, added where they coincide).

The JAX module computes this outside Pallas, and so does the port: plain
torch ops on either device.  The backward keeps one fp32 (N, T, U, V)
temporary alive (the softmax, scaled and added to in place); a fused kernel
for it is a later PR's work (ROADMAP).

Not ported: the JAX module's choices between gather formulations
(`_use_flat3d`, the compare-mask at small V).  They pick XLA lowerings; the
port has one gather.  The flat (N, T, U*V) layout is a view of the 4-D one.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.functional.core import _costs_only, _forward_backward
from warp_rnnt_tpu_torch.functional.loss import _labels_ext, _reduce


def _gather2(x4, loc_rows, blank):
    """(N, T, U, V) logits -> (blank_lp, emit_lp, logZ), (N, T, U) fp32."""
    N, T, U, V = x4.shape
    logz = torch.logsumexp(x4.float(), dim=-1)
    idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
    emit = torch.gather(x4, 3, idx)[..., 0].float()
    return x4[..., blank].float() - logz, emit - logz, logz


class _LogitsCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x4, loc_rows, xn, yn, blank, fastemit_lambda, impl):
        blank_lp, emit_lp, logz = _gather2(x4, loc_rows, blank)
        costs, g_blank, g_emit, _, _ = _forward_backward(
            blank_lp, emit_lp, xn, yn, fastemit_lambda, impl
        )
        ctx.save_for_backward(x4, loc_rows, logz, g_blank, g_emit)
        ctx.blank = blank
        return costs

    @staticmethod
    def backward(ctx, ct):
        x4, loc_rows, logz, g_blank, g_emit = ctx.saved_tensors
        N, T, U, _ = x4.shape
        ctb = ct.float()[:, None, None]
        # the one fp32 temporary, written by the subtraction itself: x4's
        # widening to fp32 is exact, so these are the bits of a copy to fp32
        # and a subtraction in place, without the copy's pass.  fp64 logits
        # round to fp32 first, as that copy did.
        if x4.dtype == torch.float64:
            d = x4.float().sub_(logz[..., None])
        else:
            d = torch.sub(x4, logz[..., None])
        d.exp_()
        d.mul_(-(ctb * (g_blank + g_emit))[..., None])
        d[..., ctx.blank] += ctb * g_blank
        idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
        d.scatter_add_(3, idx, (ctb * g_emit)[..., None])
        return d.to(x4.dtype), None, None, None, None, None, None


def _as_4d(logits, labels):
    """(N, T, U, V) view of either layout; flat derives U from the labels."""
    if logits.dim() == 4:
        N, T, U, V = logits.shape
    else:
        N, T, UV = logits.shape
        U = labels.shape[1] + 1
        if UV % U != 0:
            raise ValueError(
                f"flat logits last dim {UV} is not divisible by U={U}"
                " (expected (N, T, U*V) with U = labels.shape[1] + 1)"
            )
        V = UV // U
    if tuple(labels.shape) != (N, U - 1):
        raise ValueError(
            f"labels must have shape (N, U-1) = ({N}, {U - 1}), got"
            f" {tuple(labels.shape)}"
        )
    return logits.view(N, T, U, V)


def rnnt_logits_core(logits, labels, xn, yn, blank=0, fastemit_lambda=0.0,
                     impl="auto"):
    """Per-sample costs (N,) fp32 from raw logits, (N, T, U, V) or the flat
    (N, T, U*V) layout (whose gradient comes back flat, through the view).
    Differentiable w.r.t. the logits; without a gradient only the beta
    sweep runs."""
    x4 = _as_4d(logits, labels)
    loc_rows = _labels_ext(labels, blank)
    if not (torch.is_grad_enabled() and logits.requires_grad):
        blank_lp, emit_lp, _ = _gather2(x4, loc_rows, blank)
        return _costs_only(blank_lp, emit_lp, xn, yn, impl)
    return _LogitsCore.apply(x4, loc_rows, xn, yn, blank, fastemit_lambda, impl)


def rnnt_loss_from_logits(
    logits,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction=None,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    impl: str = "auto",
):
    """RNN-T loss on raw joint logits (fused log_softmax).  Same options as
    `rnnt_loss` minus gather/compact (the gather is always fused here).
    The logits must be contiguous; any float dtype (the gradient comes back
    in it)."""
    if reduction not in (None, "none", "mean", "sum"):
        raise ValueError(
            f"Unknown reduction method: {reduction}, expected to be one of"
            " ['mean', 'sum', 'none']"
        )
    if logits.dim() not in (3, 4):
        raise ValueError(
            "logits must have 4 dimensions (N, T, U, V) or 3 for the flat"
            " (N, T, U*V) layout"
        )
    if not logits.is_contiguous():
        raise RuntimeError("logits must be contiguous")
    xn = frames_lengths.to(torch.int32)
    yn = labels_lengths.to(torch.int32)
    costs = rnnt_logits_core(logits, labels, xn, yn, blank, fastemit_lambda,
                             impl)
    return _reduce(costs, xn, average_frames, reduction)
