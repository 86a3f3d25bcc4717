"""Alignment-restricted RNN-T loss (counterpart of
`warp_rnnt_tpu/functional/restricted.py`; AR-RNNT, arXiv:2011.03072).

Given a reference alignment (``label_frames[n, u]``, the frame at which
label u+1 occurs, e.g. from `rnnt_alignment`), label u+1 may only be
emitted inside the band

    label_frames[u] - left_context <= t <= label_frames[u] + right_context

Paths that emit outside the band leave the sum, and their cells get exactly
zero gradient.  As in the JAX package there is no banded kernel: the emit
channel of the gathered (N, T, U, 2) lattice is set to -1e30 outside the
band and goes through the same `rnnt_core` as `rnnt_loss`, so on the card
the gather, the lattice kernel and (backward, V input) the dense write run,
and the no-grad route runs the beta-only sweep.

-1e30 is also the CUDA lattice kernel's own sentinel: a log-prob at or
below it reads as "no path".  So an infeasible band (every path pruned)
gives a raw cost near 1e30 on the kernel path and on the scan alike, and
``costs < 0.5e30`` tells the two apart on both.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.functional.core import rnnt_core
from warp_rnnt_tpu_torch.functional.loss import _gather_blank_emit

NEG = -1.0e30


def band_mask(xs_gathered, label_frames, left_context, right_context):
    """Gathered (N, T, U, 2) lattice -> fp32 lattice whose emit channel is
    exactly NEG outside each label's band.  The band of row u is that of
    label u+1; row U-1 takes a label frame of 0, as in JAX (it never
    emits, so its band does not matter)."""
    N, T, U, _ = xs_gathered.shape
    dev = xs_gathered.device
    lf = torch.as_tensor(label_frames, device=dev).to(torch.int32)
    if tuple(lf.shape) != (N, U - 1):
        raise ValueError(
            f"label_frames must have shape (N, U-1) = ({N}, {U - 1}),"
            f" got {tuple(lf.shape)}"
        )
    lf_row = torch.cat([lf, lf.new_zeros((N, 1))], dim=1)  # (N, U)
    t_iota = torch.arange(T, dtype=torch.int32, device=dev)[None, :, None]
    lo = (lf_row - left_context)[:, None, :]
    hi = (lf_row + right_context)[:, None, :]
    in_band = (t_iota >= lo) & (t_iota <= hi)  # (N, T, U)
    emit = torch.where(in_band, xs_gathered[..., 1].float(), NEG)
    return torch.stack([xs_gathered[..., 0].float(), emit], dim=-1)


def rnnt_loss_restricted(
    log_probs,
    labels,
    frames_lengths,
    labels_lengths,
    label_frames,
    left_context: int = 15,
    right_context: int = 5,
    average_frames: bool = False,
    reduction=None,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    impl: str = "auto",
):
    """Alignment-restricted RNN-T loss, on the device of its inputs.

    Args:
      log_probs: (N, T, U, V) log-softmax outputs, or pre-gathered
        (N, T, U, 2) with ``blank=-1``.
      labels: (N, U-1) int32.
      frames_lengths, labels_lengths: (N,) int32.
      label_frames: (N, U-1) int — reference frame of each label (entries
        for u >= labels_lengths[n] are ignored).
      left_context, right_context: band half-widths in frames.
      Remaining args as in `rnnt_loss`.

    Returns:
      Loss with shape (N,) for reduction='none', else a scalar.  A sample
      whose band prunes every path costs +inf under 'none', with exactly
      zero gradients; 'sum' and 'mean' leave such samples out ('mean'
      divides by the feasible count), and an all-infeasible batch reduces
      to 0.0 with zero gradients.
    """
    if reduction not in (None, "none", "mean", "sum"):
        raise ValueError(
            f"Unknown reduction method: {reduction}, expected to be one of"
            " ['mean', 'sum', 'none']"
        )
    dev = log_probs.device
    xn = torch.as_tensor(frames_lengths, dtype=torch.int32, device=dev)
    yn = torch.as_tensor(labels_lengths, dtype=torch.int32, device=dev)
    if blank == -1:
        xs_gathered = log_probs
    else:
        xs_gathered = _gather_blank_emit(log_probs, labels, blank)

    xs_masked = band_mask(xs_gathered, label_frames, left_context,
                          right_context)
    costs = rnnt_core(xs_masked, xn, yn, fastemit_lambda, impl)
    # The infeasible-band contract of the JAX module: a raw cost near the
    # sentinel becomes +inf, and torch.where's gradient for that branch is
    # 0, which zeroes the sample in rnnt_core's multiply-by-cotangent
    # backward (its stored gradients are finite, so 0 * g stays 0).
    feasible = costs < -0.5 * NEG
    costs = torch.where(feasible, costs, torch.inf)
    if average_frames:
        costs = costs / xn.to(costs.dtype)
    if reduction in (None, "none"):
        return costs
    safe = torch.where(feasible, costs, 0.0)
    if reduction == "sum":
        return safe.sum()
    return safe.sum() / feasible.sum().clamp(min=1).to(safe.dtype)
