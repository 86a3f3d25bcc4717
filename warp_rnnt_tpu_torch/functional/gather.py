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
card.  There is no fallback between the two.

The vocabulary-sharded loss (`parallel.vocab`) relies on that 0: given a
column ``offset``, xs is the block [offset, offset + V) of a wider
vocabulary, the blank and the labels index the whole vocabulary, and a
blank or label outside the block gives 0, in the kernel and in its plain
twin (`ops.gather_kernels.gather_lattice_plain`, which masks them), so the
card and the CPU agree bit for bit and the blocks' lattices sum to the
whole one exactly.  The backward is the dense compare-select write

    d_xs[n, t, u, v] = ct[..., 0] * [v == blank] + ct[..., 1] * [v == loc[n, u]]

done by `ops.flat_kernels.flat_grad_write` (a CUDA kernel on the card that
reads the two channels of the fp32 cotangent in place), which
with an offset writes the block and nothing for a column outside it.  When
`loc == blank` (the last lattice row) both terms add, as a scatter-add would.

Donation (`utils.compiled_step`): where a compiled step donates the
log-probs this gather reads (the argument's whole buffer, or the 4-D view
of a flat one), the backward writes the gradient into that buffer and
returns a view of it, as ``jax.jit(..., donate_argnums=0)`` lets XLA do;
nothing reads xs after the forward (only ``loc_rows`` is saved).  Only a
compiled step's warm-up and capture mark a buffer, and a mark is taken
once: an eager call allocates its gradient as before, with the same
kernels.

The label index is frame-invariant: the loss broadcasts per-sample labels
over t, so the gather takes `loc_rows` (N, U) instead of an (N, T, U) index.

Not ported: `flat_arg_formats`.  It pins XLA parameter layouts at a jit
boundary; a contiguous torch tensor has one layout, and the 4-D and flat
views share its memory, so there is nothing to pin.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.ops import flat_kernels, gather_kernels
from warp_rnnt_tpu_torch.utils import compiled_step


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
    def forward(ctx, xs, loc_rows, blank, offset):
        ctx.save_for_backward(loc_rows)
        ctx.blank = blank
        ctx.offset = offset
        ctx.shape = tuple(xs.shape)
        ctx.dtype = xs.dtype
        # the gradient's buffer: xs's own where a compiled step donates it
        ctx.out = xs.detach() if compiled_step.take_donated(xs) else None
        if xs.is_cuda:
            return gather_kernels.gather_lattice(xs, loc_rows, blank, offset)
        if offset is not None:
            return gather_kernels.gather_lattice_plain(xs, loc_rows, blank,
                                                       offset)
        return gather_blank_label_plain(xs, loc_rows, blank)

    @staticmethod
    def backward(ctx, ct):
        (loc_rows,) = ctx.saved_tensors
        N, T, U, V = ctx.shape
        ct = ct.float().contiguous()  # the write reads its two channels
        out = None if ctx.out is None else ctx.out.view(N, T, U * V)
        d = flat_kernels.flat_grad_write(
            ct[..., 0], ct[..., 1], loc_rows, ctx.blank, V, U * V,
            out_dtype=ctx.dtype, offset=ctx.offset, out=out,
        )
        return d.view(N, T, U, V), None, None, None


def gather_blank_label(xs, loc_rows, blank: int, offset=None):
    """xs (N, T, U, V), loc_rows (N, U) int32 -> (N, T, U, 2) in xs's
    dtype: [blank entry, loc entry] of every row.  With a column
    ``offset``, xs is the vocabulary block [offset, offset + V) and an
    entry outside it is 0 (see the module docstring)."""
    return _GatherBlankLabel.apply(xs, loc_rows, blank, offset)


def gather_blank_label_flat(xs3, loc_rows, blank: int, V: int):
    """Flat layout: xs3 (N, T, U*V), loc_rows (N, U) -> (N, T, U, 2).

    The flat tensor is viewed as (N, T, U, V) (same memory, no copy) and goes
    through the same Function; the gradient comes back flat through the
    view's own backward, again without a copy.
    """
    N, T, UV = xs3.shape
    return gather_blank_label(xs3.view(N, T, UV // V, V), loc_rows, blank)
