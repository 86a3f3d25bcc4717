"""Public RNN-T loss API (counterpart of `warp_rnnt_tpu/functional/loss.py`).

Same signature, options and validation messages as the JAX package, plus the
tensor checks of the reference torch binding (contiguity, integer dtypes).
The loss runs where its inputs are: CUDA tensors go through the CUDA
kernels, CPU tensors through the plain torch scan (``impl="auto"``).  Both
values of ``gather`` take the gathered path: the (N, T, U, V) log-probs are
reduced to an (N, T, U, 2) lattice whose backward is one dense write.
``compact=True`` takes the packed (rows, V) layout through
`functional.compact`.

`reduction` and `average_frames` stay outside the autograd Function, so the
core's backward receives a per-sample cotangent.
"""

from __future__ import annotations

from typing import Optional

import torch

from warp_rnnt_tpu_torch.functional.compact import rnnt_loss_compact_costs
from warp_rnnt_tpu_torch.functional.core import rnnt_core, rnnt_core_with_internals
from warp_rnnt_tpu_torch.functional.gather import (
    gather_blank_label,
    gather_blank_label_flat,
)
from warp_rnnt_tpu_torch.ops import flat_kernels


def _labels_ext(labels, blank):
    """(N, U-1) labels -> (N, U) int32 gather indices: channel 1 of row u is
    the label y_{u+1}, and the blank for the last row."""
    N = labels.shape[0]
    return torch.cat(
        [labels.to(torch.int32),
         torch.full((N, 1), blank, dtype=torch.int32, device=labels.device)],
        dim=1,
    ).contiguous()


def _gather_blank_emit(log_probs, labels, blank):
    """(N, T, U, V) + (N, U-1) labels -> gathered (N, T, U, 2)."""
    N, T, U, V = log_probs.shape
    if tuple(labels.shape) != (N, U - 1):
        raise ValueError(
            f"labels must have shape (N, U-1) = ({N}, {U - 1}), got"
            f" {tuple(labels.shape)}"
        )
    return gather_blank_label(log_probs, _labels_ext(labels, blank), blank)


def _gather_blank_emit_flat(log_probs3, labels, blank):
    """Flat layout: (N, T, U*V) + (N, U-1) labels -> gathered (N, T, U, 2).
    U is derived from the labels (U = labels.shape[1] + 1), V = flat // U."""
    N, T, UV = log_probs3.shape
    U = labels.shape[1] + 1
    if labels.shape[0] != N:
        raise ValueError(
            f"labels batch dim {labels.shape[0]} != log_probs batch dim {N}"
        )
    if UV % U != 0:
        raise ValueError(
            f"flat log_probs last dim {UV} is not divisible by U={U}"
            " (expected (N, T, U*V) with U = labels.shape[1] + 1)"
        )
    return gather_blank_label_flat(
        log_probs3, _labels_ext(labels, blank), blank, UV // U
    )


def _validate_tensors(log_probs, labels, xn, yn, blank):
    """Checks of the reference torch binding, and one device for all."""
    if not log_probs.is_contiguous():
        raise RuntimeError("xs must be contiguous")
    if not log_probs.is_floating_point():
        raise RuntimeError("xs must be a Float tensor")
    named = [("xn", xn), ("yn", yn)]
    if blank != -1:
        named.insert(0, ("ys", labels))
    for name, x in named:
        if x.dtype != torch.int32:
            raise RuntimeError(f"{name} must be a Int tensor")
        if x.device != log_probs.device:
            raise RuntimeError(
                f"{name} is on {x.device}, xs on {log_probs.device}: all inputs"
                " must be on one device"
            )


def rnnt_loss(
    log_probs,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction: Optional[str] = "none",
    blank: int = 0,
    gather: bool = False,
    fastemit_lambda: float = 0.0,
    compact: bool = False,
    impl: str = "auto",
    max_frames: Optional[int] = None,
    max_labels: Optional[int] = None,
):
    """The RNN-Transducer loss, on the device of its inputs.

    Args:
      log_probs: (N, T, U, V) log-softmax outputs, where U = max(yn) + 1.
        A 3-D (N, T, U*V) tensor is the flat layout (U derived from the
        labels); its gradient comes back flat.  With ``blank=-1`` a
        pre-gathered (N, T, U, 2) lattice is expected (channel 0 = blank,
        1 = label).  Any floating dtype; the lattice is computed in fp32 and
        the gradient returned in the input dtype.  Must be contiguous.
      labels: (N, U-1) int32 reference labels (unused when ``blank=-1``;
        compact: (sum(yn),)).
      frames_lengths: (N,) int32 number of valid frames per sample.
      labels_lengths: (N,) int32 number of labels per sample.
      average_frames: divide each sample's loss by its frame count.
      reduction: 'none' | 'sum' | 'mean' (None == 'none').
      blank: blank symbol index, or -1 for pre-gathered inputs.
      gather: accepted for reference API parity; both values take the
        gathered path.
      fastemit_lambda: FastEmit regularization (arXiv:2010.11148).
      compact: the packed ragged layout (reference compact mode):
        ``log_probs`` is (rows, V) with rows >= sum(xn * (yn + 1)), labels
        (sum(yn),); the gradient comes back packed, zero on pad rows (see
        `warp_rnnt_tpu_torch.functional.compact`).  CUDA tensors go through
        the packed gather/scatter kernels.
      impl: 'auto' | 'cuda' | 'scan' backend selector.
      max_frames/max_labels: lattice bounds of the compact layout (default
        max(xn), max(yn)); a bound below the lengths raises.

    Returns:
      Loss with shape (N,) for reduction='none', else a scalar.
    """
    if average_frames is not None and not isinstance(average_frames, bool):
        raise ValueError("average_frames must be a bool")
    if reduction not in (None, "none", "mean", "sum"):
        raise ValueError(
            f"Unknown reduction method: {reduction}, expected to be one of"
            " ['mean', 'sum', 'none']"
        )
    if not isinstance(blank, int):
        raise ValueError("blank must be an int")
    xn, yn = frames_lengths, labels_lengths
    if compact:
        _validate_tensors(log_probs, labels, xn, yn, blank)
        costs = rnnt_loss_compact_costs(
            log_probs, labels, xn, yn, blank=blank,
            fastemit_lambda=fastemit_lambda, impl=impl,
            max_frames=max_frames, max_labels=max_labels,
        )
        return _reduce(costs, xn, average_frames, reduction)

    if log_probs.dim() not in (3, 4):
        raise ValueError(
            "log_probs must have 4 dimensions (N, T, U, V) or 3 for the"
            " flat (N, T, U*V) layout"
        )
    _validate_tensors(log_probs, labels, xn, yn, blank)
    if blank == -1:
        if log_probs.dim() != 4 or log_probs.shape[-1] != 2:
            raise ValueError(
                "blank=-1 expects pre-gathered log_probs with last dim 2"
            )
        xs_gathered = log_probs
    elif log_probs.dim() == 3:
        xs_gathered = _gather_blank_emit_flat(log_probs, labels, blank)
    else:
        xs_gathered = _gather_blank_emit(log_probs, labels, blank)
    costs = rnnt_core(xs_gathered, xn, yn, fastemit_lambda, impl)
    return _reduce(costs, xn, average_frames, reduction)


def _reduce(costs, xn, average_frames, reduction):
    """average_frames, then the reduction; outside the autograd Functions,
    so their backward receives a per-sample cotangent."""
    if average_frames:
        costs = costs / xn.to(costs.dtype)
    if reduction in (None, "none"):
        return costs
    if reduction == "sum":
        return costs.sum()
    return costs.mean()


def rnnt_loss_with_internals(
    log_probs, labels, frames_lengths, labels_lengths,
    blank: int = 0, fastemit_lambda: float = 0.0, impl: str = "auto",
    return_mismatch: bool = False,
):
    """Debug/conformance entry for the padded layout (no autograd).

    Returns (costs (N,), grads, alphas (N,T,U), betas (N,T,U)) where grads is
    (N, T, U, V) with the two gathered gradients written into the full
    vocabulary (zeros elsewhere), or (N, T, U, 2) when blank=-1.

    With ``return_mismatch=True`` a fifth element is appended: the (N,) bool
    forward/backward canary mask (True = that sample's grads were zeroed and
    its cost averaged).  ``WARP_RNNT_DEBUG=1`` also warns when it trips.
    """
    from warp_rnnt_tpu_torch.functional.postprocess import mismatch_mask

    _validate_tensors(log_probs, labels, frames_lengths, labels_lengths, blank)
    xn, yn = frames_lengths, labels_lengths
    with torch.no_grad():
        if blank == -1:
            xs_gathered = log_probs
        else:
            xs_gathered = _gather_blank_emit(log_probs, labels, blank)
        costs, grads_g, alphas, betas = rnnt_core_with_internals(
            xs_gathered, xn, yn, fastemit_lambda, impl
        )
        grads = grads_g
        if blank != -1:
            N, T, U, V = log_probs.shape
            grads = flat_kernels.flat_grad_write(
                grads_g[..., 0], grads_g[..., 1],
                _labels_ext(labels, blank), blank, V, U * V,
                out_dtype=grads_g.dtype,
            ).view(N, T, U, V)
        out = (costs, grads, alphas, betas)
        if return_mismatch:
            bad = mismatch_mask(xs_gathered[..., 0].float(), alphas, betas, xn, yn)
            out = out + (bad,)
    return out
