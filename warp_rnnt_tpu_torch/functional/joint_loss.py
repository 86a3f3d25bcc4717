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

# "auto" on a CUDA device takes the fused kernels where V >= _CUDA_FUSED_MIN_V
# and H <= _CUDA_FUSED_MAX_H (None: never), "padded" elsewhere.  The JAX
# package's `_FUSED_MIN_V = 40` is a TPU measurement and is not carried
# over: on the TPU a wider joint only widens the fused win, here it does
# not.  Past one 256-column slice (`ops.fused_joint.bwd_plan`) the fused
# backward does S + 1 products against the bound's 2 (1.5x at H=512, 2.4x
# at H=640, 2.5x at H=1024), while the padded layout's products grow only
# as H; the forward does one at every H.  Loss+grad ms of
# `rnnt_loss_joint`, bf16 joint, F=256, T=150, 20 labels (40 at V=28),
# random lengths, padded and fused in turns (padded, fused, fused,
# padded): chained, then the device busy ms a call under the profiler, in
# turns again; two calls, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (`chip_smoke.py` `time_route_sweep`), with the forward on wgmma:
#   V      H     N   call  chained: padded     fused        device: padded     fused
#   28     256   16  1      5.17  5.41   5.36  5.08       0.91  0.91   0.95  0.95
#                    2      7.29  7.45   6.85  7.58       0.91  0.91   0.95  0.96
#   256    256   16  1      6.56  5.77   6.56  5.83       0.96  0.96   0.55  0.55
#                    2      7.26  6.34   6.61  6.43       0.96  0.96   0.55  0.55
#   1000   256   16  1      6.33  5.41   6.26  5.89       2.21  2.21   0.80  0.80
#                    2      7.15  6.86   8.04  6.96       2.21  2.21   0.80  0.80
#   5000   256   16  1      8.40  8.64   6.35  4.95       8.59  8.60   1.88  1.88
#                    2      8.32  8.55   8.14  7.35       8.57  8.62   1.86  1.87
#   5000   512   16  1      8.29  9.14   6.41  6.32       9.10  9.08   5.13  5.10
#                    2      9.14  9.05   7.37  7.01       9.09  9.12   5.05  5.03
#   5000   640   16  1      9.66  9.70   9.84  9.61       9.64  9.63   9.73  9.37
#                    2      9.55  9.61   9.66  8.95       9.59  9.58   9.53  9.53
#   5000   1024  16  1     10.21 10.07  16.31 16.29      10.19 10.17  16.30 16.33
#                    2     10.19 10.17  16.22 16.14      10.19 10.17  15.97 15.96
#   64000  256   2   1     12.94 13.02   7.02  6.83      13.09 13.07   2.68  2.67
#                    2     13.00 13.02   6.56  6.71      13.08 12.72   2.65  2.66
#   64000  512   2   1     13.77 13.80   8.55  8.65      13.84 13.56   8.51  8.46
#                    2     13.80 13.80   8.98  8.75      13.94 13.81   8.48  8.44
#   64000  640   2   1     14.18 14.22  15.85 15.61      14.29 14.26  15.63 15.63
#                    2     14.18 14.24  15.36 15.48      14.30 14.27  15.43 15.41
#   64000  1024  2   1     15.55 15.59  27.44 27.39      15.61 15.58  27.22 27.40
#                    2     15.56 15.61  27.40 27.13      15.64 15.60  27.17 26.96
# The chained times read the host where the device is idle (fused below
# V=5000 and at V=5000, H=256; both layouts below V=1000), and the host's
# speed differs from call to call.  Fused wins every reading, chained and
# on the device, at V=5000 and 64000 for H=256 and 512; below V=5000 the
# chained readings overlap; at H=640 the two tie at V=5000 (fused 0.5 %
# ahead on the device in call 2, mixed chained) and padded wins at
# V=64000; at H=1024 padded wins every reading.  So fused from V=5000
# (the smallest measured V from which fused wins every reading at every
# measured V above it) and up to H=512 (the widest measured H at which it
# does).  With the earlier, fragment-based forward the two tied at
# V=64000, H=512 (13.8 against 13.8 ms), so the limit was 256.  Fused also
# holds far less peak memory (0.056 against 1.93 GiB at V=5000, H=256); a
# caller short of memory asks for layout="fused" at any V and H.
_CUDA_FUSED_MIN_V: Optional[int] = 5000
_CUDA_FUSED_MAX_H: int = 512


def joint_layout_route(T: int, U: int, H: int, V: int, N: int = 1,
                       platform: Optional[str] = None) -> str:
    """The routing policy of ``layout="auto"``: "fused" or "padded".

    ``platform`` is the device type the call runs on ("cuda" or "cpu";
    None: "cuda" when a CUDA device is present).  The CPU answer is
    "padded", as the JAX package answers off the TPU.  The CUDA answer
    comes from `_CUDA_FUSED_MIN_V` and `_CUDA_FUSED_MAX_H`, set from the
    H100 times beside them: "fused" from V=5000 at joint widths up to 512,
    "padded" elsewhere.  T, U and N are accepted for API parity and do not
    move the answer.  U counts lattice rows (labels + 1).
    """
    del T, U, N
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda" and _CUDA_FUSED_MIN_V is not None:
        fused = V >= _CUDA_FUSED_MIN_V and H <= _CUDA_FUSED_MAX_H
        return "fused" if fused else "padded"
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
