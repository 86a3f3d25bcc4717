"""Compact (packed, padding-free) RNN-T loss layout (counterpart of
`warp_rnnt_tpu/functional/compact.py`).

Reference contract (warp-rnnt's compact mode): log-probs arrive packed as
``xs (rows, V)``, each sample's (xn, yn + 1) lattice flattened row-major and
the samples concatenated, ``rows >= sum(xn * (yn + 1))`` (rows past it are a
bucketed buffer's padding); labels packed as ``ys (sum(yn),)``.  Per-sample
costs come back, and the gradient in the same packed layout, in the input
dtype, zero on pad rows.

Two routes, chosen by the tensors' device:
  * CUDA: `ops.packed_kernels.packed_lattice` -- one host call from
    (xs, ys, xn, yn) to the (N, T, U, 2) lattice (a prefix scan and the
    packed gather kernel), the lattice sweep, and on backward the packed
    scatter kernel on the cotangent as it comes and the forward's meta.
    With no gradient the beta-only sweep runs.
  * CPU: the plain composition of the JAX module -- `compact_gather` to
    packed (rows, 2), then `compact_to_padded`, whose hand-written backward
    gathers by row coordinates and masks pad rows.

Host reads: eagerly, `_static_bounds` reads the lengths once per call (one
``.cpu()``) to size the lattice and to check the buffer and the bounds a
caller gives; the kernels themselves need no host value.

Under a compiled step (`utils.compiled_step`, the port's ``jax.jit``:
while `compiled_step.tracing()`), as under JAX's jit, the host reads
nothing: ``max_frames`` and ``max_labels`` must both be given (else
ValueError, JAX's message) and are taken as they are, unchecked, and so
are the buffer's rows, the labels' count and their range.  The lengths
are then clamped on the device to [0, max_frames] and [0, max_labels]
before they reach the kernels (`_traced_lengths`), so every kernel stays
inside its buffers whatever the lengths are; on lengths within the bounds
the clamp changes nothing, and the result is the eager call's, bit for
bit.  A bound below a length gives, without an error, the loss of the
batch whose lengths are so clamped, its rows laid out for the clamped
lengths: the samples after the first one clamped read rows shifted from
their own.  JAX's jit gives no error either; it keeps the true layout and
clamps its gather indices at the lattice's edge (XLA's rule for an index
out of range), so neither is the loss of the batch.  Labels outside
[0, V) or rows past the buffer give NaN costs on the card (the packed
gather's rule, `csrc/packed.cu`).

Not ported, by design: `_FORCE_KERNEL` and `_use_movement_kernel`.  They pick
between the TPU's movement kernels and XLA's gather by vocabulary size, a
TPU measurement; here the device picks the route.
"""

from __future__ import annotations

from typing import Optional

import torch

from warp_rnnt_tpu_torch.functional.core import rnnt_core, rnnt_core_with_internals
from warp_rnnt_tpu_torch.ops import packed_kernels
from warp_rnnt_tpu_torch.ops.packed_kernels import lattice_rows, row_coordinates
from warp_rnnt_tpu_torch.utils import compiled_step


def _static_bounds(xs, ys, xn, yn, max_frames=None, max_labels=None):
    """(T, max_labels) of a packed batch from one host read, and
    the checks the kernels rely on: ``max_frames >= max(xn)``,
    ``max_labels >= max(yn)``, ``rows >= sum(xn * (yn + 1))``,
    ``len(ys) >= sum(yn)`` and labels in [0, V).  Raises ValueError.
    Under a compiled step's trace: the bounds as given, no read and no
    check (module docstring)."""
    if compiled_step.tracing():
        if max_frames is None or max_labels is None:
            raise ValueError("compact mode under jit requires static"
                             " max_frames / max_labels")
        return int(max_frames), int(max_labels)
    stats = [xn.max(), yn.max(), (xn.long() * (yn.long() + 1)).sum(), yn.sum()]
    if ys.shape[0]:
        stats += [ys.min(), ys.max()]
    stats = torch.stack([s.long() for s in stats]).cpu().tolist()
    top_x, top_y, valid, n_labels = stats[:4]
    if max_frames is None:
        max_frames = top_x
    elif max_frames < top_x:
        raise ValueError(f"max_frames={max_frames} is below max(xn)={top_x}")
    if max_labels is None:
        max_labels = top_y
    elif max_labels < top_y:
        raise ValueError(f"max_labels={max_labels} is below max(yn)={top_y}")
    if xs.shape[0] < valid:
        raise ValueError(
            f"compact log_probs has {xs.shape[0]} rows, fewer than"
            f" sum(xn * (yn + 1)) = {valid}"
        )
    if ys.shape[0] < n_labels:
        raise ValueError(
            f"compact labels has {ys.shape[0]} entries, fewer than"
            f" sum(yn) = {n_labels}"
        )
    if ys.shape[0] and not 0 <= stats[4] <= stats[5] < xs.shape[1]:
        raise ValueError(f"labels outside [0, {xs.shape[1]})")
    return max_frames, max_labels


def _traced_lengths(xn, yn, T: int, max_labels: int):
    """The lengths the kernels see: as given eagerly (checked against the
    bounds), clamped on the device to [0, T] and [0, max_labels] under a
    compiled step's trace (module docstring)."""
    if not compiled_step.tracing():
        return xn, yn
    return xn.clamp(0, T), yn.clamp(0, max_labels)


def _row_labels(rows: int, ys, xn, yn, blank: int):
    """(rows,) int32 vocabulary index of channel 1 at each packed row: the
    next label, or the blank on each sample's last row."""
    n, _, u, _ = row_coordinates(rows, xn, yn)
    if ys.shape[0] == 0:
        next_label = torch.full((rows,), blank, dtype=torch.int32,
                                device=xn.device)
    else:
        label_pref = torch.cumsum(yn.long(), 0) - yn.long()
        pos = (label_pref[n] + u).clamp(0, ys.shape[0] - 1)
        next_label = ys.to(torch.int32)[pos]
    return torch.where(u < yn.long()[n], next_label, blank).to(torch.int32)


def compact_gather(xs, ys, xn, yn, blank: int = 0):
    """Packed (rows, V) -> packed 2-wide lattice (rows, 2) plus ``loc``
    (rows,) int32, the vocabulary index of channel 1 at each row (the next
    label, or the blank on each sample's last row)."""
    loc = _row_labels(xs.shape[0], ys, xn, yn, blank)
    label_col = torch.gather(xs, 1, loc.long()[:, None])[:, 0]
    return torch.stack([xs[:, blank], label_col], dim=-1), loc


class _CompactToPadded(torch.autograd.Function):
    """Packed (rows, 2) -> (N, T, U, 2), 0 at invalid cells.  The backward
    is the inverse gather by row coordinates, pad rows masked to 0 (the
    clamped coordinates would alias them onto real cells)."""

    @staticmethod
    def forward(ctx, g, xn, yn, T, U):
        pos, valid = lattice_rows(xn, yn, T, U)
        padded = g[torch.where(valid, pos, 0)]
        ctx.save_for_backward(xn, yn)
        ctx.rows = g.shape[0]
        return torch.where(valid[..., None], padded, 0.0)

    @staticmethod
    def backward(ctx, ct):
        xn, yn = ctx.saved_tensors
        n, t, u, valid = row_coordinates(ctx.rows, xn, yn)
        T, U = ct.shape[1], ct.shape[2]
        d = ct[n, t.clamp(0, T - 1), u.clamp(0, U - 1)]
        return torch.where(valid[:, None], d, 0.0), None, None, None, None


def compact_to_padded(g, xn, yn, T: int, U: int):
    """Unpack packed (rows, 2) rows into a dense (N, T, U, 2) block."""
    return _CompactToPadded.apply(g, xn, yn, T, U)


def _padded_lattice(xs, ys, xn, yn, blank, T, U):
    """The (N, T, U, 2) lattice of a packed batch, through the kernels on a
    CUDA tensor and the plain composition on a CPU tensor."""
    if xs.device.type == "cuda":
        return packed_kernels.packed_lattice(xs, ys.contiguous(), xn, yn,
                                             blank, T, U)
    gathered, _ = compact_gather(xs, ys, xn, yn, blank)
    return compact_to_padded(gathered.float(), xn, yn, T, U)


def _check_dims(xs, ys, blank):
    if xs.dim() != 2:
        raise ValueError("compact log_probs must have 2 dimensions (STU, V)")
    if ys.dim() != 1:
        raise ValueError("compact labels must have 1 dimension (sum(yn),)")
    if not 0 <= blank < xs.shape[1]:
        raise ValueError(f"compact mode needs blank in [0, {xs.shape[1]}),"
                         f" got {blank}")


def rnnt_loss_compact_costs(
    xs, ys, xn, yn,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    impl: str = "auto",
    max_frames: Optional[int] = None,
    max_labels: Optional[int] = None,
):
    """Differentiable per-sample costs (N,) fp32 for the packed layout.

    xs (rows, V) any float dtype (the gradient comes back in it); ys
    (sum(yn),) int32; xn, yn (N,) int32.  ``max_frames``/``max_labels``
    set the lattice bounds (default max(xn), max(yn)); a bound below the
    lengths raises, except under a compiled step, which needs both and
    checks neither (module docstring).
    """
    _check_dims(xs, ys, blank)
    T, max_y = _static_bounds(xs, ys, xn, yn, max_frames, max_labels)
    xn, yn = _traced_lengths(xn, yn, T, max_y)
    padded = _padded_lattice(xs, ys, xn, yn, blank, T, max_y + 1)
    return rnnt_core(padded, xn, yn, fastemit_lambda, impl)


def rnnt_loss_compact_with_internals(
    xs, ys, xn, yn,
    blank: int = 0, fastemit_lambda: float = 0.0, impl: str = "auto",
    max_frames: Optional[int] = None, max_labels: Optional[int] = None,
):
    """Conformance entry (no autograd): (costs, packed (rows, V) fp32
    grads, loc (rows,)), the reference's compact forward followed by its
    backward with unit upstream gradients.  Pad rows' grads are 0; where
    loc == blank both gradients add at the blank column.  The packed
    gather and scatter run as kernels on a CUDA tensor."""
    _check_dims(xs, ys, blank)
    T, max_y = _static_bounds(xs, ys, xn, yn, max_frames, max_labels)
    xn, yn = _traced_lengths(xn, yn, T, max_y)
    rows, V = xs.shape
    with torch.no_grad():
        padded, loc, pref = packed_kernels.packed_gather_lattice(
            xs, ys.contiguous(), xn, yn, blank, T, max_y + 1)
        costs, grads_padded, _, _ = rnnt_core_with_internals(
            padded, xn, yn, fastemit_lambda, impl
        )
        grads = packed_kernels.packed_scatter(
            grads_padded.float().contiguous(), loc, pref, xn, yn, blank, rows,
            V, torch.float32)
    return costs, grads, _row_labels(rows, ys, xn, yn, blank)
