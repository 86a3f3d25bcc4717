"""Data-parallel RNN-T loss over a mesh (counterpart of
`warp_rnnt_tpu/parallel/loss_parallel.py`).

Both routes take this rank's local shards (its samples; for
`rnnt_loss_sharded` on a mesh with a 'model' axis and
``vocab_axis="model"``, its block of the vocabulary too) and return what
the single-process call on the global batch returns:

  * `rnnt_loss_shard_map`: the explicit route of the JAX module
    (`loss_parallel.py:55-83`): the local `rnnt_loss(reduction="none")`,
    then a differentiable all_reduce over 'data': the SUM for "sum", the
    mean of the equal shards' means for "mean"; "none" returns the local
    costs.  As in JAX, the batch must divide evenly over 'data' (checked:
    one all_reduce of the local batch size and a host read).
  * `rnnt_loss_sharded`: the meaning of the JAX module's GSPMD route: the
    result and the gradient equal the single-process call on the global
    batch.  It all-reduces the global sum and the global count, so that
    ragged shards, ``average_frames`` and the restricted loss's
    feasible-only mean (``label_frames``) come out as one process gives
    them.  ``compact=True`` takes each rank's packed rows (`shard_packed`
    splits a global packed batch by sample); the lattice bounds default to
    the global ``max(xn)`` and ``max(yn)`` (one all_reduce and a host
    read), so that every rank sweeps the lattice the single-process call
    sweeps.

The all_reduce passes the cotangent on unchanged (`mesh.reduce_sum`):
every rank holds the same reduced loss and backpropagates it into its own
samples, which is their exact gradient.  Besides that and the compact
bounds, nothing communicates: each sample's lattice is computed where its
log-probs are, by the kernels of the single-process path (the gather, the
lattice sweep, the write; the packed kernels for ``compact``).  With
`rnnt_loss_sharded`'s ``vocab_axis`` the lattice comes from
`parallel.vocab.vocab_lattice` (each rank gathers its block with its column
offset, and the blocks are summed over the axis) and the loss runs on it
with ``blank=-1``.
"""

from __future__ import annotations

from typing import Optional

import torch

from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.functional.restricted import rnnt_loss_restricted
from warp_rnnt_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    mesh_device,
    min_max,
    reduce_sum,
)
from warp_rnnt_tpu_torch.parallel.vocab import vocab_lattice

_REDUCTIONS = (None, "none", "mean", "sum")


def _check_reduction(reduction):
    if reduction not in _REDUCTIONS:
        raise ValueError(
            f"Unknown reduction method: {reduction}, expected to be one of"
            " ['mean', 'sum', 'none']"
        )


def _local_costs(mesh, log_probs, labels, xn, yn, vocab_axis, label_frames,
                 kwargs):
    """Per-sample costs (N_r,) of this rank's samples: `rnnt_loss`, or
    `rnnt_loss_restricted` when ``label_frames`` is given, with
    reduction "none"; from the vocabulary-sharded lattice with
    ``vocab_axis``."""
    kwargs = dict(kwargs)
    if vocab_axis is not None:
        if kwargs.get("compact"):
            raise ValueError("compact log-probs are split over 'data' only,"
                             " not over the vocabulary")
        log_probs = vocab_lattice(log_probs, labels, kwargs.pop("blank", 0),
                                  mesh, axis=vocab_axis)
        kwargs["blank"] = -1
    if label_frames is not None:
        return rnnt_loss_restricted(log_probs, labels, xn, yn, label_frames,
                                    reduction="none", **kwargs)
    return rnnt_loss(log_probs, labels, xn, yn, reduction="none", **kwargs)


def _global_bounds(mesh, xn, yn, axis, kwargs):
    """``kwargs`` with the compact lattice bounds left out set to the
    largest ``xn`` and ``yn`` over ``axis`` (a rank may hold no sample)."""
    missing = [k for k in ("max_frames", "max_labels")
               if kwargs.get(k) is None]
    if not missing:
        return kwargs
    dev = mesh_device(mesh)
    top = torch.stack([torch.cat([x.reshape(-1).long().to(dev),
                                  torch.zeros(1, dtype=torch.long, device=dev)])
                       .max() for x in (xn, yn)])
    _, hi = min_max(top, mesh, axis)
    bounds = dict(zip(("max_frames", "max_labels"), hi.tolist()))
    return {**kwargs, **{k: bounds[k] for k in missing}}


def rnnt_loss_sharded(
    mesh,
    log_probs,
    labels,
    frames_lengths,
    labels_lengths,
    reduction: Optional[str] = "mean",
    axis: str = "data",
    vocab_axis: Optional[str] = None,
    label_frames=None,
    **kwargs,
):
    """The loss of the global batch from this rank's shards.

    Args:
      mesh: a `DeviceMesh` (`parallel.mesh.make_mesh`).
      log_probs, labels, frames_lengths, labels_lengths: this rank's
        samples, as `rnnt_loss` takes them (``compact=True``: its packed
        rows and labels).  With ``vocab_axis`` the log-probs are this
        rank's block of the vocabulary (V / axis size columns, in rank
        order) and the labels and ``blank`` index the whole vocabulary.
      reduction: "none" returns this rank's costs; "sum" and "mean" the
        global value on every rank.  "mean" divides the global sum by the
        global count of samples, or, with ``label_frames``, of feasible
        samples (0.0 when none is).
      axis: the batch axis.
      label_frames: (N_r, U-1) reference frames: the alignment-restricted
        loss (`rnnt_loss_restricted`; ``left_context`` and
        ``right_context`` in kwargs), whose infeasible samples cost +inf
        under "none" and are left out of "sum" and "mean".
      **kwargs: the other options of `rnnt_loss` (``average_frames``,
        ``blank``, ``fastemit_lambda``, ``compact``, ``impl``, ...).  With
        ``compact=True``, ``max_frames`` and ``max_labels`` left out are the
        global batch's (the rank's own would give other rounding).
    """
    _check_reduction(reduction)
    if kwargs.get("compact"):
        kwargs = _global_bounds(mesh, frames_lengths, labels_lengths, axis,
                                kwargs)
    costs = _local_costs(mesh, log_probs, labels, frames_lengths,
                         labels_lengths, vocab_axis, label_frames, kwargs)
    if reduction in (None, "none"):
        return costs
    if label_frames is not None:
        feasible = torch.isfinite(costs)
        costs = torch.where(feasible, costs, 0.0)
        count = feasible.sum()
    else:
        count = torch.tensor(costs.shape[0], device=costs.device)
    total = reduce_sum(torch.stack([costs.sum(), count.to(costs.dtype)]),
                       mesh, axis)
    if reduction == "sum":
        return total[0]
    return total[0] / total[1].clamp(min=1)


def rnnt_loss_shard_map(
    mesh,
    log_probs,
    labels,
    frames_lengths,
    labels_lengths,
    reduction: Optional[str] = "mean",
    axis: str = "data",
    **kwargs,
):
    """Explicit-SPMD data-parallel loss: the local per-sample costs, then
    one differentiable all_reduce over ``axis``.

    Every rank must hold the same number of samples (the JAX route's
    even split); a rank that differs raises ValueError on every rank.
    reduction "none" returns this rank's costs; "sum" and "mean" (the mean
    of the shards' means) the global value on every rank."""
    _check_reduction(reduction)
    n = torch.tensor(frames_lengths.shape[0], device=mesh_device(mesh))
    lo, hi = (int(v) for v in min_max(n, mesh, axis))
    if lo != hi:
        raise ValueError(f"the batch does not divide evenly over '{axis}':"
                         f" the ranks hold {lo} to {hi} samples")
    costs = _local_costs(mesh, log_probs, labels, frames_lengths,
                         labels_lengths, None, None, kwargs)
    if reduction in (None, "none"):
        return costs
    if reduction == "sum":
        return reduce_sum(costs.sum(), mesh, axis)
    return reduce_sum(costs.mean(), mesh, axis) / axis_size(mesh, axis)


def shard_packed(mesh, xs, ys, xn, yn, axis: str = "data"):
    """A global packed batch (`rnnt_loss(compact=True)`'s layout: xs
    (rows, V), ys (sum(yn),), xn, yn (N,)) -> this rank's (xs, ys, xn, yn):
    its equal block of samples, and their rows and labels, which follow the
    prefix sums of xn * (yn + 1) and of yn, not N / D.  Reads the lengths
    on the host; the tensors land on the rank's device."""
    dev = mesh_device(mesh)
    count, index = axis_size(mesh, axis), axis_index(mesh, axis)
    N = xn.shape[0]
    if N % count:
        raise ValueError(f"{N} samples do not divide over the {count} ranks"
                         f" of '{axis}'")
    lo, hi = index * N // count, (index + 1) * N // count
    xl, yl = xn.long().cpu(), yn.long().cpu()
    rows = torch.cumsum(torch.cat([xl.new_zeros(1), xl * (yl + 1)]), 0)
    labs = torch.cumsum(torch.cat([yl.new_zeros(1), yl]), 0)
    return (xs[int(rows[lo]):int(rows[hi])].to(dev).contiguous(),
            ys[int(labs[lo]):int(labs[hi])].to(dev).contiguous(),
            xn[lo:hi].to(dev).contiguous(), yn[lo:hi].to(dev).contiguous())
