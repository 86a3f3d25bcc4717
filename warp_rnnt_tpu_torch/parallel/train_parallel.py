"""The transducer's train step over a ('data',) or ('data', 'model') mesh:
what the JAX package gets from ``jax.jit(make_train_step)`` on sharded
inputs (`__graft_entry__.py:56-86`), written out for `torch.distributed`.

  * `shard_model(model, mesh)`: checks that every parameter is equal on
    every rank, then, on a mesh whose 'model' axis has more than one rank
    (the vocabulary route below), keeps this rank's block of the
    vocabulary in the joint's output projection (weight rows and bias), as
    the JAX dry run's ``param_spec`` shards it.
  * `make_sharded_train_step(model, optimizer, mesh, ...)` returns
    ``step(batch) -> loss`` as `models.make_train_step` does, for this
    rank's block of the batch.  The loss of each rank's samples:
      - without a 'model' axis, or with one of one rank (nothing to
        split), `models.transducer_loss_fn`;
      - on more model ranks, in "from_logits" and "gather", the joint's
        hidden layer passes `vocab.copy_to_model` (so its gradient sums
        every block's share) into the rank's block of the output
        projection, and the block of logits goes through the
        vocabulary-parallel logsumexp and gather (`vocab.vocab_lattice`;
        "gather" normalizes with `vocab.vocab_log_softmax` first, as the
        unsharded mode does);
      - in "fused", the fused kernels need the whole W: it is rebuilt by
        an all_reduce SUM of the zero-filled blocks (`_WholeVocab`), and
        the backward keeps this rank's block of d_W and d_b.  Every model
        rank computes the same whole gradient, so it needs no model
        all_reduce.
    Then one all_reduce SUM over 'data' of every gradient and the loss,
    flattened into one buffer, divided by the data size (the mean of the
    equal shards' means), and the `torch.optim` step.  AdamW is
    elementwise, so a sharded W steps exactly as the unsharded one.
"""

from __future__ import annotations

import torch
from torch import nn

from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.models.joint import _dense, joint_hidden
from warp_rnnt_tpu_torch.models.transducer import LOSS_MODES, transducer_loss_fn
from warp_rnnt_tpu_torch.ops.fused_joint import rnnt_loss_fused_joint
from warp_rnnt_tpu_torch.parallel.mesh import (
    all_reduce,
    axis_index,
    axis_size,
    min_max,
)
from warp_rnnt_tpu_torch.parallel.vocab import (
    MODEL,
    copy_to_model,
    mesh_vocab_block,
    vocab_lattice,
    vocab_log_softmax,
)

DATA = "data"


def splits_vocab(mesh) -> bool:
    """Whether ``mesh`` splits the vocabulary: a 'model' axis of more than
    one rank, which takes the vocabulary route."""
    return axis_size(mesh, MODEL) > 1


def shard_model(model, mesh):
    """Check that every parameter of ``model`` is the same on every rank,
    then, on a mesh that splits the vocabulary (`splits_vocab`), replace
    the joint's output projection by this rank's block of the vocabulary
    (weight rows and bias; a vocabulary that does not divide raises
    ValueError).  Returns
    ``model``, changed in place; build the optimizer after this call."""
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    lo, hi = min_max(flat)
    if not (torch.equal(lo, flat) and torch.equal(hi, flat)):
        raise ValueError("the model's parameters differ across ranks")
    if splits_vocab(mesh):
        out = model.joint.out
        offset, width = mesh_vocab_block(mesh, out.out_features)
        with torch.no_grad():
            out.weight = nn.Parameter(out.weight[offset:offset + width].clone())
            out.bias = nn.Parameter(out.bias[offset:offset + width].clone())
        out.out_features = width
    return model


class _WholeVocab(torch.autograd.Function):
    """The rank's block (V_r, ...) -> the whole (V, ...) tensor, by an
    all_reduce SUM of zero-filled blocks over 'model'.  The backward keeps
    the block's rows of the whole gradient, which every model rank computes
    alike."""

    @staticmethod
    def forward(ctx, block, mesh):
        m, index = axis_size(mesh, MODEL), axis_index(mesh, MODEL)
        width = block.shape[0]
        whole = block.new_zeros((m * width, *block.shape[1:]))
        whole[index * width:(index + 1) * width] = block
        ctx.rows = (index * width, (index + 1) * width)
        return all_reduce(whole, mesh, MODEL)

    @staticmethod
    def backward(ctx, ct):
        lo, hi = ctx.rows
        return ct[lo:hi], None


def _vocab_parallel_loss(model, batch, mesh, fastemit_lambda, loss_mode):
    """The mean loss of this rank's samples with the joint's output
    projection sharded over 'model' (the rank's block; on a 'model' axis of
    one rank, or none, the block is the whole vocabulary and the route
    gives the single-process loss)."""
    feats, labels, xn, yn = batch
    j = model.joint
    f, g = model.encode(feats), model.predictor(labels)
    if loss_mode == "fused":
        w = _WholeVocab.apply(j.out.weight, mesh)
        b = _WholeVocab.apply(j.out.bias, mesh)
        params = {"w_pre": j.pre.weight.t(), "b_pre": j.pre.bias,
                  "w_out": w.t(), "b_out": b}
        return rnnt_loss_fused_joint(f, g, params, labels, xn, yn,
                                     reduction="mean",
                                     fastemit_lambda=fastemit_lambda,
                                     mode=model.joint_mode)
    cd = j.compute_dtype
    h = joint_hidden(f, g, j.pre.weight.t(), j.pre.bias, model.joint_mode, cd)
    logits = _dense(copy_to_model(h, mesh), j.out.weight.t(), j.out.bias,
                    cd).float()
    if loss_mode == "from_logits":
        lattice = vocab_lattice(logits, labels, 0, mesh, from_logits=True)
    else:
        lattice = vocab_lattice(vocab_log_softmax(logits, mesh), labels, 0,
                                mesh)
    return rnnt_loss(lattice, labels, xn, yn, reduction="mean", blank=-1,
                     fastemit_lambda=fastemit_lambda)


def sharded_loss_fn(model, batch, mesh, fastemit_lambda=0.0,
                    loss_mode: str = "from_logits"):
    """The mean loss of this rank's block of the batch, with the model as
    `shard_model` left it (the same on every model rank)."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode: {loss_mode!r}")
    if not splits_vocab(mesh):
        return transducer_loss_fn(model, batch, fastemit_lambda, loss_mode)
    return _vocab_parallel_loss(model, batch, mesh, fastemit_lambda,
                                loss_mode)


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer, mesh,
                            fastemit_lambda: float = 0.0,
                            loss_mode: str = "from_logits"):
    """Returns ``step(batch) -> loss`` for this rank's block of the batch
    (every 'data' rank the same number of samples): zero the gradients,
    the loss of the rank's samples and its backward, one all_reduce over
    'data' of the gradients and the loss (divided by the data size), one
    optimizer step.  The loss comes back detached, the global mean, the
    same on every rank.  ``model`` is as `shard_model` left it."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode: {loss_mode!r}")
    params = [p for p in model.parameters() if p.requires_grad]
    data = axis_size(mesh, DATA)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = sharded_loss_fn(model, batch, mesh, fastemit_lambda, loss_mode)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().reshape(1).float()])
        all_reduce(flat, mesh, DATA).div_(data)
        offset = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
            offset += n
        optimizer.step()
        return flat[-1]

    return step
