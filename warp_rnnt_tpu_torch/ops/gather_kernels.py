"""CUDA column gathers (`csrc/gather.cu`) and their plain torch versions:
the port's counterparts of the gather experiments the JAX package keeps
under `scripts/` (`exp_colgather.py`, `exp_pallas_gather.py`), which compute
the main path's blank/label gather, or its dense VJP, in other layouts.

  * `gather_columns_flat` replaces `_gather_cols_manual_kernel`: a
    frame-invariant column gather, xs3 (N, T, C) and cols (N, K) ->
    (N, T, K) in xs3's dtype.
  * `gather_fwd` replaces the streaming `_gather_kernel`: the blank and
    label channels of xs (N, T, U, V), each (N, T, U) fp32.
  * `gather_fwd_sparse` replaces `_sparse_gather_kernel`: the same two
    channels from the flat (N, T, U*V) view, laid out (N, U, T).
  * `scatter_bwd` stands for `_scatter_kernel`, the dense VJP
    ``ct_b * [v == blank] + ct_l * [v == lab]`` on (N, T, U, V).  That is
    `flat_kernels.flat_grad_write`'s function on the same memory, so it runs
    that kernel on a view and counts under ``flat_write``.

The first three are one kernel.  A column outside [0, C), or a label
outside [0, V), gives 0, in the kernel and in the plain versions alike.
(The JAX streaming kernel's masked sum gives 0 for a label at -1 or past
its padded V block, and sums the block's padding for one inside it; its
sparse kernel reads the neighbouring row's entry.)  On a CUDA
tensor the wrappers launch the kernel, or raise; on a CPU tensor they run
the plain versions beside them.  What bounds the kernel and what its design
does about it is noted at the top of `csrc/gather.cu`.

Not ported, by design: `_GATHER_MAX_COLS` (the JAX function splits K > 64
into several calls to fit the TPU's VMEM; one launch takes any K),
`gather_columns_supported` (C >= 128, the TPU's lane window) and
`_choose_blocks` (VMEM block sizes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from warp_rnnt_tpu_torch.ops import _build, flat_kernels
from warp_rnnt_tpu_torch.ops.packed_kernels import _DTYPE_CODES, _kernel_ready

# Launches per wrapper, counted where the kernel is launched and nowhere else.
LAUNCHES = {"gather_columns": 0, "gather_fwd": 0, "gather_fwd_sparse": 0}

_THREADS = 256


def _lib():
    lib = _build.load("gather")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnnt_gather_columns.argtypes = [p, i, p, p, i, i, ll, i, p]
        lib.rnnt_gather_blank_label.argtypes = [p, i, p, p] + [i] * 6 + [p]
        lib.rnnt_gather_columns.restype = i
        lib.rnnt_gather_blank_label.restype = i
        lib.rnnt_gather_error_string.argtypes = [i]
        lib.rnnt_gather_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(xs, ndim, idx, idx_name, K):
    """xs: an ndim-D float tensor; idx: (N, K) int32 on xs's device."""
    if xs.dim() != ndim or xs.dtype not in _DTYPE_CODES:
        raise ValueError(f"xs must be a {ndim}-D float tensor, got"
                         f" {tuple(xs.shape)} {xs.dtype}")
    if tuple(idx.shape) != (xs.shape[0], K):
        raise ValueError(f"{idx_name} must have shape ({xs.shape[0]}, {K}),"
                         f" got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{idx_name} must be torch.int32, got {idx.dtype}")
    if idx.device != xs.device:
        raise ValueError(f"{idx_name} is on {idx.device}, xs on {xs.device}")


def _check_labels(xs, ndim, labels_ext, blank, V):
    """xs (N, T, U, V) (ndim 4) or (N, T, U*V) (ndim 3), labels_ext (N, U)."""
    U = labels_ext.shape[-1] if labels_ext.dim() else -1
    _check(xs, ndim, labels_ext, "labels_ext", U)
    if math.prod(xs.shape[2:]) != U * V:
        raise ValueError(f"xs frame of shape {tuple(xs.shape[2:])} does not"
                         f" hold U*V = {U}*{V} values")
    if not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")


def _launch_ready(xs, idx, idx_name, total):
    _kernel_ready((("xs", xs), (idx_name, idx)), xs.device)
    if -(-total // _THREADS) >= 2**31:
        raise ValueError(f"{total} gathered values exceed the kernel's grid")


def blank_label_cols(labels_ext, blank: int, V: int):
    """(N, U) int32 labels -> (N, 2U) int32 columns of the flat (N, T, U*V)
    view: the U blank columns ``u*V + blank``, then the U label columns
    ``u*V + labels_ext[n, u]`` (the columns `gather_fwd` reads)."""
    N, U = labels_ext.shape
    off = torch.arange(U, dtype=torch.int32, device=labels_ext.device) * V
    return torch.cat([(off + blank).expand(N, U), labels_ext + off],
                     dim=1).contiguous()


def gather_columns_flat_plain(xs3, cols):
    """Plain torch version of `gather_columns_flat`."""
    _check(xs3, 3, cols, "cols", cols.shape[-1])
    N, T, C = xs3.shape
    valid = (cols >= 0) & (cols < C)
    idx = torch.where(valid, cols, 0).long()[:, None, :].expand(N, T, -1)
    return torch.where(valid[:, None, :], torch.gather(xs3, 2, idx), 0)


def gather_columns_flat(xs3, cols):
    """xs3 (N, T, C) any float dtype, cols (N, K) int32 -> (N, T, K) in
    xs3's dtype: ``out[n, t, k] = xs3[n, t, cols[n, k]]``, 0 where
    cols[n, k] is outside [0, C).  One launch takes any K (the JAX
    function's split of K > 64 is a TPU VMEM limit, not ported).  A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    if xs3.device.type == "cpu":
        return gather_columns_flat_plain(xs3, cols)
    _check(xs3, 3, cols, "cols", cols.shape[-1])
    (N, T, C), K = xs3.shape, cols.shape[1]
    _launch_ready(xs3, cols, "cols", N * T * K)
    out = torch.empty((N, T, K), dtype=xs3.dtype, device=xs3.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(xs3.device).cuda_stream
    with torch.cuda.device(xs3.device):
        code = lib.rnnt_gather_columns(
            xs3.data_ptr(), _DTYPE_CODES[xs3.dtype], cols.data_ptr(),
            out.data_ptr(), N, T, C, K, stream)
    _build.check(lib, "rnnt_gather_error_string", code, "rnnt_gather_columns")
    LAUNCHES["gather_columns"] += 1
    return out


def _blank_label(xs, labels_ext, blank, V, ut_layout, counter):
    """Launch the blank/label kernel: (2, N, T, U) or, with ut_layout,
    (2, N, U, T) fp32; returns the two channels."""
    N, T = xs.shape[:2]
    U = labels_ext.shape[1]
    _launch_ready(xs, labels_ext, "labels_ext", N * T * 2 * U)
    shape = (2, N, U, T) if ut_layout else (2, N, T, U)
    out = torch.empty(shape, dtype=torch.float32, device=xs.device)
    if out.numel() > 0:
        lib = _lib()
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        with torch.cuda.device(xs.device):
            code = lib.rnnt_gather_blank_label(
                xs.data_ptr(), _DTYPE_CODES[xs.dtype], labels_ext.data_ptr(),
                out.data_ptr(), N, T, U, V, blank, int(ut_layout), stream)
        _build.check(lib, "rnnt_gather_error_string", code,
                     "rnnt_gather_blank_label")
        LAUNCHES[counter] += 1
    return out[0], out[1]


def gather_fwd_plain(xs, labels_ext, blank: int):
    """Plain torch version of `gather_fwd`."""
    _check_labels(xs, 4, labels_ext, blank, xs.shape[-1])
    N, T, U, V = xs.shape
    valid = (labels_ext >= 0) & (labels_ext < V)
    idx = torch.where(valid, labels_ext, 0).long()[:, None, :, None]
    lab = torch.gather(xs, 3, idx.expand(N, T, U, 1))[..., 0]
    lab = torch.where(valid[:, None, :], lab, 0)
    return xs[..., blank].float().contiguous(), lab.float().contiguous()


def gather_fwd(xs, labels_ext, blank: int):
    """xs (N, T, U, V) any float dtype, labels_ext (N, U) int32 (the last
    column the blank, as the loss builds it) -> (blank_col, label_col),
    each (N, T, U) fp32: xs[..., blank] and xs[n, t, u, labels_ext[n, u]],
    0 where the label is outside [0, V).  A CUDA tensor launches the
    kernel, a CPU tensor runs the plain version."""
    if xs.device.type == "cpu":
        return gather_fwd_plain(xs, labels_ext, blank)
    V = xs.shape[-1]
    _check_labels(xs, 4, labels_ext, blank, V)
    return _blank_label(xs, labels_ext, blank, V, False, "gather_fwd")


def gather_fwd_sparse_plain(xs3, labels_ext, blank: int, V: int):
    """Plain torch version of `gather_fwd_sparse`."""
    _check_labels(xs3, 3, labels_ext, blank, V)
    N, T, _ = xs3.shape
    b, lab = gather_fwd_plain(xs3.reshape(N, T, -1, V), labels_ext, blank)
    return b.transpose(1, 2).contiguous(), lab.transpose(1, 2).contiguous()


def gather_fwd_sparse(xs3, labels_ext, blank: int, V: int):
    """The channels of `gather_fwd` from the flat view xs3 (N, T, U*V),
    each laid out (N, U, T) fp32.  A CUDA tensor launches the kernel, a CPU
    tensor runs the plain version."""
    if xs3.device.type == "cpu":
        return gather_fwd_sparse_plain(xs3, labels_ext, blank, V)
    _check_labels(xs3, 3, labels_ext, blank, V)
    return _blank_label(xs3, labels_ext, blank, V, True, "gather_fwd_sparse")


def scatter_bwd_plain(ct_blank, ct_label, labels_ext, blank: int, V: int):
    """Plain torch version of `scatter_bwd`."""
    N, T, U = ct_blank.shape
    return flat_kernels.flat_grad_write_plain(
        ct_blank, ct_label, labels_ext, blank, V, U * V).view(N, T, U, V)


def scatter_bwd(ct_blank, ct_label, labels_ext, blank: int, V: int):
    """VJP of `gather_fwd`: (N, T, U) fp32 cotangents -> the dense
    (N, T, U, V) fp32 ``ct_blank * [v == blank] + ct_label * [v == lab]``
    (both add where lab == blank).  `flat_kernels.flat_grad_write` viewed
    as (N, T, U, V): its kernel on a CUDA tensor, counted under
    ``flat_write``; its plain version on a CPU tensor."""
    N, T, U = ct_blank.shape
    return flat_kernels.flat_grad_write(
        ct_blank, ct_label, labels_ext, blank, V, U * V).view(N, T, U, V)
