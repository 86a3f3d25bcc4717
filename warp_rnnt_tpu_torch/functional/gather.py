"""Blank/label gather with a dense, scatter-free backward (counterpart of
`warp_rnnt_tpu/functional/gather.py`).

From each (V,) row of log-probs only the blank entry and one label entry
survive, as the (N, T, U, 2) lattice the loss core takes, in the input's
dtype.  On the card the forward is one launch of the column-gather kernel
(`ops.gather_kernels.gather_lattice`, `csrc/gather.cu`), which writes the
interleaved lattice itself; on the CPU it is `gather_blank_label_plain`,
one `torch.gather` and a stack.  The two give the same values bit for bit
(values are moved, never rounded), with one difference outside the
function's domain: a label outside [0, V) gives 0 in the kernel, where
`torch.gather` raises on the CPU and stops with a device-side assert on the
card.  There is no fallback between the two.  The backward is the dense
compare-select write

    d_xs[n, t, u, v] = ct[..., 0] * [v == blank] + ct[..., 1] * [v == loc[n, u]]

done by `ops.flat_kernels.flat_grad_write` (a CUDA kernel on the card).  When
`loc == blank` (the last lattice row) both terms add, as a scatter-add would.

The label index is frame-invariant: the loss broadcasts per-sample labels
over t, so the gather takes `loc_rows` (N, U) instead of an (N, T, U) index.

Not ported: `flat_arg_formats`.  It pins XLA parameter layouts at a jit
boundary; a contiguous torch tensor has one layout, and the 4-D and flat
views share its memory, so there is nothing to pin.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.ops import flat_kernels, gather_kernels


def gather_blank_label_plain(xs, loc_rows, blank: int):
    """The plain forward: xs (N, T, U, V), loc_rows (N, U) int32 ->
    (N, T, U, 2) in xs's dtype, by one `torch.gather` and a stack."""
    N, T, U, V = xs.shape
    idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
    label_col = torch.gather(xs, 3, idx)[..., 0]
    return torch.stack([xs[..., blank], label_col], dim=-1)


class _GatherBlankLabel(torch.autograd.Function):
    """xs (N, T, U, V), loc_rows (N, U) int32 -> (N, T, U, 2)."""

    @staticmethod
    def forward(ctx, xs, loc_rows, blank):
        ctx.save_for_backward(loc_rows)
        ctx.blank = blank
        ctx.shape = tuple(xs.shape)
        ctx.dtype = xs.dtype
        if xs.is_cuda:
            return gather_kernels.gather_lattice(xs, loc_rows, blank)
        return gather_blank_label_plain(xs, loc_rows, blank)

    @staticmethod
    def backward(ctx, ct):
        (loc_rows,) = ctx.saved_tensors
        N, T, U, V = ctx.shape
        ct = ct.float()
        d = flat_kernels.flat_grad_write(
            ct[..., 0].contiguous(), ct[..., 1].contiguous(), loc_rows,
            ctx.blank, V, U * V, out_dtype=ctx.dtype,
        )
        return d.view(N, T, U, V), None, None


def gather_blank_label(xs, loc_rows, blank: int):
    """xs (N, T, U, V), loc_rows (N, U) int32 -> (N, T, U, 2) in xs's
    dtype: [blank entry, loc entry] of every row."""
    return _GatherBlankLabel.apply(xs, loc_rows, blank)


def gather_blank_label_flat(xs3, loc_rows, blank: int, V: int):
    """Flat layout: xs3 (N, T, U*V), loc_rows (N, U) -> (N, T, U, 2).

    The flat tensor is viewed as (N, T, U, V) (same memory, no copy) and goes
    through the same Function; the gradient comes back flat through the
    view's own backward, again without a copy.
    """
    N, T, UV = xs3.shape
    return gather_blank_label(xs3.view(N, T, UV // V, V), loc_rows, blank)
