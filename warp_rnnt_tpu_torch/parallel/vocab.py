"""Vocabulary parallelism over a mesh's 'model' axis: what GSPMD does for the
JAX package when the log-probs, or the joint's output projection, are
sharded over V (`tests/test_models_and_parallel.py:152-181`,
`__graft_entry__.py:56-69`), written out as torch collectives.

Each rank of a 'model' group holds one equal block [offset, offset + V_r)
of the vocabulary (`vocab_block`, `shard_vocab`).  The operators follow one
rule: every rank of the group computes the same loss from the same
replicated values, and each backward returns this rank's exact share of
the gradient.

  * `mesh.reduce_sum` over 'model': all_reduce SUM in the forward,
    identity in the backward (the cotangent of a replicated value is
    already whole).
  * `copy_to_model`: identity in the forward, all_reduce SUM in the
    backward.  It sits where a replicated value feeds a computation on the
    rank's block (the joint's hidden layer before the column-sharded
    output projection; the logsumexp before a blockwise log_softmax), so
    that its gradient sums every block's share.
  * `vocab_gather`: the blank/label lattice from the rank's block.  Each
    rank gathers with its own column offset (`functional.gather`; a blank
    or label outside the block gives 0, in the kernel and its plain twin),
    then `reduce_sum` over the group sums the blocks: exactly the whole
    lattice, since every entry is one block's value plus zeros.  The backward is
    the rank's local dense write, in which out-of-block columns receive
    nothing.
  * `vocab_logsumexp`: logsumexp over the whole V from the blocks: the
    MAX of the blocks' maxima, then the SUM of exp(x - max), both
    all-reduced.  Its backward is ct * softmax on the block.

`vocab_lattice` composes them into the (N, T, U, 2) lattice a loss takes
with ``blank=-1``: from log-probs (the gather), or from raw logits (the
gather minus the logsumexp: the from-logits loss).  Every collective is an
all_reduce, as `parallel.mesh` requires.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from warp_rnnt_tpu_torch.functional.gather import gather_blank_label
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.parallel.mesh import (
    all_reduce,
    axis_index,
    axis_size,
    reduce_sum,
)

MODEL = "model"


def vocab_block(V: int, count: int, index: int):
    """(offset, width) of block ``index`` of ``count`` equal blocks of a
    vocabulary of V; a V that does not divide raises ValueError."""
    if V % count:
        raise ValueError(f"a vocabulary of {V} does not divide over the"
                         f" {count} ranks of the '{MODEL}' axis")
    width = V // count
    return index * width, width


def mesh_vocab_block(mesh, V: int, axis: str = MODEL):
    """(offset, width) of this rank's block of a vocabulary of V."""
    return vocab_block(V, axis_size(mesh, axis), axis_index(mesh, axis))


def shard_vocab(mesh, x, axis: str = MODEL):
    """This rank's block of the last dim of the global tensor ``x``,
    contiguous."""
    offset, width = mesh_vocab_block(mesh, x.shape[-1], axis)
    return x[..., offset:offset + width].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct.clone(), ctx.mesh, ctx.axis), None, None


def copy_to_model(x, mesh, axis: str = MODEL):
    """``x`` itself; the backward sums the cotangent over ``axis``."""
    return _CopyToModel.apply(x, mesh, axis)


class _VocabLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        xf = x.float()
        m = all_reduce(xf.amax(dim=-1), mesh, axis, dist.ReduceOp.MAX)
        # a row of -inf (no finite entry in any block) keeps lse = -inf
        shift = torch.where(torch.isfinite(m), m, 0.0)
        s = all_reduce((xf - shift[..., None]).exp().sum(dim=-1), mesh, axis)
        lse = shift + s.log()
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, ct):
        x, lse = ctx.saved_tensors
        d = (x.float() - lse[..., None]).exp_().mul_(ct[..., None])
        return d.to(x.dtype), None, None


def vocab_logsumexp(x, mesh, axis: str = MODEL):
    """logsumexp over the whole vocabulary of the rank's block ``x``
    (..., V_r) -> (...) fp32, the same on every rank of ``axis``."""
    return _VocabLogsumexp.apply(x, mesh, axis)


def vocab_gather(xs, labels, blank: int, mesh, axis: str = MODEL):
    """xs (N, T, U, V_r), this rank's block of (N, T, U, V) log-probs;
    labels (N, U-1) int32 of the whole vocabulary -> the (N, T, U, 2)
    lattice in xs's dtype, the same on every rank of ``axis``."""
    N, T, U, Vr = xs.shape
    if tuple(labels.shape) != (N, U - 1):
        raise ValueError(f"labels must have shape (N, U-1) = ({N}, {U - 1}),"
                         f" got {tuple(labels.shape)}")
    offset = axis_index(mesh, axis) * Vr
    local = gather_blank_label(xs, _labels_ext(labels, blank), blank, offset)
    return reduce_sum(local, mesh, axis)


def vocab_lattice(x, labels, blank: int, mesh, from_logits: bool = False,
                  axis: str = MODEL):
    """The (N, T, U, 2) lattice of this rank's vocabulary block ``x``
    (N, T, U, V_r): of log-probs in x's dtype, or with ``from_logits`` of
    raw logits, fp32, with the log_softmax over the whole vocabulary folded
    in (lattice = gathered logits - logsumexp), as
    `functional.from_logits` computes it unsharded."""
    lat = vocab_gather(x, labels, blank, mesh, axis)
    if not from_logits:
        return lat
    return lat.float() - vocab_logsumexp(x, mesh, axis)[..., None]


def vocab_log_softmax(x, mesh, axis: str = MODEL):
    """log_softmax over the whole vocabulary of the rank's block ``x``
    (..., V_r) -> (..., V_r) fp32.  The logsumexp passes `copy_to_model`,
    so its gradient sums every block's share."""
    lse = copy_to_model(vocab_logsumexp(x, mesh, axis), mesh, axis)
    return x.float() - lse[..., None]
