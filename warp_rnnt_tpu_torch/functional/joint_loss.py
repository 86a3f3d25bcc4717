"""Joint network + RNN-T loss with a layout dispatcher (counterpart of
`warp_rnnt_tpu/functional/joint_loss.py`).

Every layout computes the same function, the Tanh-MLP joint of
`models/joint.py` with the same parameters followed by the loss; the layout
is an execution strategy:

  * "fused":   `ops.fused_joint.rnnt_loss_fused_joint`, the joint's output
               projection, logsumexp and blank/label pick in the fused
               kernels; the (N, T, U, V) logits never exist.  bf16 only.
  * "padded":  `models.joint.joint_logits` materializes the logits, and
               `functional.from_logits.rnnt_loss_from_logits` folds the
               log_softmax into the loss.
  * "compact": only the sum(xn * (yn + 1)) valid cells are projected: the
               pre-projections a, c are gathered per packed row, projected
               to (rows, V), log_softmax'ed and handed to
               ``rnnt_loss(compact=True)`` (the packed gather/scatter
               kernels on the card).  Its packing indices are read from the
               lengths on the host.
  * "auto":    `joint_layout_route` for the tensors' device.

The JAX module's `_pre_projections` is `ops.fused_joint._project` here, the
one pre-projection of the port.  Its `_FUSED_MIN_V` is a TPU measurement and
is not carried over; `_CUDA_FUSED_MIN_V` takes its place, set from this
port's own H100 times.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from warp_rnnt_tpu_torch.functional.from_logits import rnnt_loss_from_logits
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.models.joint import joint_logits
from warp_rnnt_tpu_torch.ops.fused_joint import _project, rnnt_loss_fused_joint
from warp_rnnt_tpu_torch.ops.packed_kernels import row_coordinates

# The V from which "auto" takes the fused kernels on a CUDA device; None:
# never, so CUDA routes "padded" at every V.  The JAX package's
# `_FUSED_MIN_V = 40` is a TPU measurement and is not carried over.
# Loss+grad ms of `rnnt_loss_joint`, bf16 joint, H=F=256, random lengths,
# on an NVIDIA H100 80GB HBM3 at 700.00 W (`chip_smoke.py`, three runs;
# two at V=256 and V=64000), padded | fused:
#   V=28    N=16 T=150 40 labels   3.05 4.28 4.41 | 3.79 4.79 5.53
#   V=256   N=16 T=150 20 labels   5.83 4.84      | 4.38 3.44
#   V=1000  N=16 T=150 20 labels   3.79 3.07 4.84 | 3.59 3.68 3.87
#   V=5000  N=16 T=150 20 labels   8.53 8.65 8.64 | 8.54 8.66 8.64
#   V=64000 N=2  T=150 20 labels, full lengths  13.04 13.07 | 19.54 19.68
# Fused loses at V=28 and V=64000 and ties at V=5000, so no threshold
# "fused from V" wins: padded everywhere.  Fused holds less peak memory,
# 30x less at V=5000 (0.064 against 1.93 GiB); a caller short of memory
# asks for layout="fused".
_CUDA_FUSED_MIN_V: Optional[int] = None


def joint_layout_route(T: int, U: int, H: int, V: int, N: int = 1,
                       platform: Optional[str] = None) -> str:
    """The routing policy of ``layout="auto"``: "fused" or "padded".

    ``platform`` is the device type the call runs on ("cuda" or "cpu";
    None: "cuda" when a CUDA device is present).  The CPU answer is
    "padded", as the JAX package answers off the TPU.  The CUDA answer
    comes from `_CUDA_FUSED_MIN_V`, which the H100 times beside it leave
    at None: "padded" at every V.  T, U, H and N are accepted for API
    parity and do not move the answer.  U counts lattice rows (labels + 1).
    """
    del T, U, H, N
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda" and _CUDA_FUSED_MIN_V is not None:
        return "fused" if V >= _CUDA_FUSED_MIN_V else "padded"
    return "padded"


def _project_out(a, c, params, combine, compute_dtype=torch.bfloat16):
    """logits = tanh(combine(a, c)) @ w_out + b_out: operands rounded to
    ``compute_dtype``, sums in fp32.  The whole combine -> tanh -> project
    chain is recomputed in the backward (a non-reentrant checkpoint), so
    autograd keeps a and c, not the fp32 (rows, H) tanh output."""
    def project(a, c, w_out, b_out):
        h = torch.tanh(combine(a, c)).to(compute_dtype).float()
        return torch.matmul(h, w_out.to(compute_dtype).float()) + b_out.float()

    return checkpoint(project, a, c, params["w_out"], params["b_out"],
                      use_reentrant=False)


def _host_lengths(frames_lengths, labels_lengths):
    """The lengths as numpy int64 arrays, read from the device once."""
    both = torch.stack([torch.as_tensor(frames_lengths).long(),
                        torch.as_tensor(labels_lengths).long()]).cpu().numpy()
    return both[0], both[1]


def pack_joint_metadata(frames_lengths, labels_lengths):
    """Host-side packing indices of the compact layout: (n_idx, t_idx,
    u_idx) int32 tensors of length sum(xn * (yn + 1)) mapping each packed
    row to its (sample, frame, label-row) cell, on the lengths' device (the
    CPU for numpy lengths).  One host read of the lengths."""
    device = (frames_lengths.device if isinstance(frames_lengths, torch.Tensor)
              else torch.device("cpu"))
    xn, yn = (torch.as_tensor(x) for x in _host_lengths(frames_lengths,
                                                        labels_lengths))
    rows = int((xn * (yn + 1)).sum())
    return tuple(x.to(device, torch.int32)
                 for x in row_coordinates(rows, xn, yn)[:3])


def rnnt_loss_joint(
    f,
    g,
    params: dict,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction: Optional[str] = None,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    mode: str = "add",
    layout: str = "auto",
    impl: str = "auto",
    compute_dtype=torch.bfloat16,
):
    """Joint network + RNN-T loss, in the layout asked for.

    f (N, T, F) encoder outputs, g (N, U, F') predictor outputs,
    ``params = dict(w_pre, b_pre, w_out, b_out)`` (the Tanh-MLP joint in the
    Flax layout; "concat" mode splits w_pre into row blocks), labels
    (N, U-1) int32, lengths (N,).  Differentiable w.r.t. f, g and all four
    parameters in every layout.

    ``compute_dtype`` is the joint's matmul dtype (the lattice is always
    fp32): bf16 by default, as the fused kernels are; torch.float32 makes
    "auto" take "padded" and "fused" raise.  ``layout``: "auto", "fused",
    "padded" or "compact" (see the module docstring).
    """
    kw = dict(average_frames=average_frames, reduction=reduction, blank=blank,
              fastemit_lambda=fastemit_lambda, impl=impl)
    if layout == "auto":
        layout = joint_layout_route(
            f.shape[1], g.shape[1], params["w_out"].shape[0],
            params["w_out"].shape[1], N=f.shape[0], platform=f.device.type,
        )
        if compute_dtype != torch.bfloat16:
            layout = "padded"  # the fused kernels are bf16 by construction
    if layout == "fused":
        if compute_dtype != torch.bfloat16:
            raise ValueError(
                "layout='fused' computes the joint in bf16; use"
                " layout='padded' (or 'auto') for"
                f" compute_dtype={compute_dtype}"
            )
        return rnnt_loss_fused_joint(f, g, params, labels, frames_lengths,
                                     labels_lengths, mode=mode, **kw)
    if layout == "padded":
        logits = joint_logits(f, g, params, mode, compute_dtype, normalize=False)
        return rnnt_loss_from_logits(logits, labels, frames_lengths,
                                     labels_lengths, **kw)
    if layout == "compact":
        a, c = _project(f, g, params, mode, compute_dtype)
        xn_h, yn_h = _host_lengths(frames_lengths, labels_lengths)
        xn = torch.as_tensor(frames_lengths, device=f.device).to(torch.int32)
        yn = torch.as_tensor(labels_lengths, device=f.device).to(torch.int32)
        n_idx, t_idx, u_idx, _ = row_coordinates(int((xn_h * (yn_h + 1)).sum()),
                                                 xn, yn)
        rows = _project_out(
            a, c, params, lambda a, c: a[n_idx, t_idx] + c[n_idx, u_idx],
            compute_dtype,
        )
        # packed labels: sample i's first yn[i] labels, in sample order
        keep = (torch.arange(labels.shape[1], device=labels.device)[None, :]
                < yn.to(labels.device)[:, None])
        return rnnt_loss(
            torch.log_softmax(rows, dim=-1), labels[keep].to(torch.int32), xn,
            yn, compact=True, max_frames=int(xn_h.max()),
            max_labels=int(yn_h.max()), **kw,
        )
    raise ValueError(
        f"unknown layout: {layout!r}, expected one of"
        " ['auto', 'fused', 'padded', 'compact']"
    )
