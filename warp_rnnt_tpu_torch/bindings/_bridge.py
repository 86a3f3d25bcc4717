"""The torch half of the TensorFlow front end (`bindings/tf_binding.py`):
torch tensors in, torch tensors out, and no TensorFlow, so it runs and is
checked where TensorFlow is absent (`benchmarks/bridge_cases.py`).

Each function runs on the device of its inputs: on a CUDA device through
the port's kernels, on the CPU through their plain versions.  Integer
inputs may come in any integer dtype (the TF side hands them over as
int64) and are cast to the int32 the losses take.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.functional.joint_loss import rnnt_loss_joint
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss_with_internals
from warp_rnnt_tpu_torch.ops.fused_joint import rnnt_loss_fused_joint

# The joint parameters, in the order the TF ops pass them.
JOINT_PARAMS = ("w_pre", "b_pre", "w_out", "b_out")
# The joint losses the TF front end reaches, by the name it passes.
JOINT_LOSSES = {"fused": rnnt_loss_fused_joint, "routed": rnnt_loss_joint}


def _int32(*xs):
    return [x.to(torch.int32).contiguous() for x in xs]


def transducer_costs_and_grads(xs, ys, xn, yn, blank: int = 0,
                               fastemit_lambda: float = 0.0):
    """Per-sample costs (N,) fp32 and the gradient of each cost w.r.t. xs:
    (N, T, U, V) in xs's dtype, the blank and label gradients written into
    the vocabulary by `ops.flat_kernels.flat_grad_write`, or (N, T, U, 2)
    when ``blank == -1`` (xs pre-gathered).  The costs and gradients of
    `functional.loss.rnnt_loss_with_internals`."""
    ys, xn, yn = _int32(ys, xn, yn)
    costs, grads, _, _ = rnnt_loss_with_internals(
        xs, ys, xn, yn, blank=blank, fastemit_lambda=fastemit_lambda)
    return costs.float(), grads.to(xs.dtype)


def _joint_call(kind, f, g, weights, labels, xn, yn, blank, fastemit_lambda,
                mode):
    labels, xn, yn = _int32(labels, xn, yn)
    return JOINT_LOSSES[kind](
        f, g, dict(zip(JOINT_PARAMS, weights)), labels, xn, yn,
        reduction="none", blank=blank, fastemit_lambda=fastemit_lambda,
        mode=mode)


def joint_costs(kind, f, g, w_pre, b_pre, w_out, b_out, labels, xn, yn,
                blank=0, fastemit_lambda=0.0, mode="add"):
    """Per-sample costs (N,) of the joint loss ``kind`` ("fused":
    `ops.fused_joint.rnnt_loss_fused_joint`; "routed":
    `functional.joint_loss.rnnt_loss_joint`, whose "auto" layout routes
    on the inputs' device), with no autograd graph."""
    with torch.no_grad():
        return _joint_call(kind, f, g, (w_pre, b_pre, w_out, b_out), labels,
                           xn, yn, blank, fastemit_lambda, mode).float()


def joint_grads(kind, f, g, w_pre, b_pre, w_out, b_out, labels, xn, yn,
                upstream, blank=0, fastemit_lambda=0.0, mode="add"):
    """The gradients of sum_n upstream[n] * cost[n] w.r.t. f, g and the
    four weights, in that order: the forward runs again, with autograd, and
    `torch.autograd.grad` takes the upstream as its cotangent.  A weight
    the loss does not reach gets zeros."""
    leaves = [x.detach().requires_grad_()
              for x in (f, g, w_pre, b_pre, w_out, b_out)]
    with torch.enable_grad():
        costs = _joint_call(kind, leaves[0], leaves[1], leaves[2:], labels,
                            xn, yn, blank, fastemit_lambda, mode)
        grads = torch.autograd.grad(costs, leaves, upstream.to(costs.dtype),
                                    allow_unused=True)
    return [torch.zeros_like(x) if d is None else d
            for x, d in zip(leaves, grads)]
