"""Differentiable RNN-T loss core on gathered (blank, emit) lattices
(counterpart of `warp_rnnt_tpu/functional/core.py`).

`rnnt_core` is the entry every loss surface lowers to:

  * when no gradient is needed (grad mode off, or the input does not require
    grad), ONE backward sweep computes the costs -- the beta-only kernel on
    the card.  The route is chosen before `Function.apply`, because a
    Function's forward always runs.
  * otherwise `_RNNTCore.forward` runs both sweeps and the epilogue, which
    gives the (N, T, U, 2) gradient w.r.t. the gathered log-probs in the
    input dtype (on the card the epilogue kernel writes it interleaved, with
    no stack and no cast); `backward` is one elementwise multiply by the
    per-sample cotangent.

Backends (``impl``):
  * "cuda": the CUDA lattice kernels (`ops.cuda_impl`); on a CPU tensor that
    module runs its plain torch twin.
  * "scan": the plain torch column scan (`functional.scan_impl`), any device.
  * "auto": "cuda" for a CUDA tensor, "scan" for a CPU tensor.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.functional import scan_impl


def _backend(impl: str, device: torch.device):
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "scan"
    if impl == "scan":
        return scan_impl
    if impl == "cuda":
        from warp_rnnt_tpu_torch.ops import cuda_impl

        return cuda_impl
    raise ValueError(f"unknown impl: {impl!r}")


def _forward_backward(blank_lp, emit_lp, xn, yn, fastemit_lambda, impl):
    return _backend(impl, blank_lp.device).forward_backward(
        blank_lp, emit_lp, xn, yn, fastemit_lambda
    )


def _forward_backward_gathered(xs_gathered, xn, yn, fastemit_lambda, impl,
                              dtype=None):
    """(costs, grads (N, T, U, 2) in ``dtype`` (default the lattice's),
    alphas, betas) of the gathered lattice."""
    return _backend(impl, xs_gathered.device).forward_backward_gathered(
        xs_gathered, xn, yn, fastemit_lambda, dtype
    )


def _costs_only(blank_lp, emit_lp, xn, yn, impl):
    return _backend(impl, blank_lp.device).costs_only(blank_lp, emit_lp, xn, yn)


class _RNNTCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs_gathered, xn, yn, fastemit_lambda, impl):
        costs, grads, _, _ = _forward_backward_gathered(
            xs_gathered, xn, yn, fastemit_lambda, impl
        )
        ctx.save_for_backward(grads)
        return costs

    @staticmethod
    def backward(ctx, ct):
        (grads,) = ctx.saved_tensors
        return grads * ct[:, None, None, None].to(grads.dtype), None, None, None, None


def rnnt_core(xs_gathered, xn, yn, fastemit_lambda=0.0, impl="auto"):
    """Per-sample negative log-likelihoods (N,) fp32 of gathered lattices.

    Args:
      xs_gathered: (N, T, U, 2) log-probs; channel 0 = blank, 1 = next label.
      xn, yn: (N,) int32 frame/label lengths on the same device.
      fastemit_lambda: FastEmit regularization weight.
      impl: backend selector, see the module docstring.
    """
    if not (torch.is_grad_enabled() and xs_gathered.requires_grad):
        lat = xs_gathered.float()  # one cast, whole; fp32 as it is
        return _costs_only(lat[..., 0], lat[..., 1], xn, yn, impl)
    return _RNNTCore.apply(xs_gathered, xn, yn, fastemit_lambda, impl)


def rnnt_core_with_internals(xs_gathered, xn, yn, fastemit_lambda=0.0, impl="auto"):
    """Non-differentiable debug/conformance entry: returns
    (costs, grads (N,T,U,2), alphas, betas)."""
    with torch.no_grad():
        return _forward_backward_gathered(xs_gathered, xn, yn,
                                          fastemit_lambda, impl,
                                          dtype=torch.float32)
