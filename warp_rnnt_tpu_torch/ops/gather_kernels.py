"""CUDA column gathers (`csrc/gather.cu`) and their plain torch versions:
the main path's blank/label gather, and the port's counterparts of the
gather experiments the JAX package keeps under `scripts/`
(`exp_colgather.py`, `exp_pallas_gather.py`), which compute the same
gather, or its dense VJP, in other layouts.

  * `gather_lattice` is the main path's forward gather: the blank and label
    log-probs of xs (N, T, U, V) as the (N, T, U, 2) lattice the loss core
    takes, in xs's dtype (`functional.gather` launches it on the card).
  * `gather_columns_flat` replaces `_gather_cols_manual_kernel`: a
    frame-invariant column gather, xs3 (N, T, C) and cols (N, K) ->
    (N, T, K) in xs3's dtype.
  * `gather_fwd` replaces the streaming `_gather_kernel`: the blank and
    label channels of xs (N, T, U, V), one (2, N, T, U) fp32 tensor.
  * `gather_fwd_sparse` replaces `_sparse_gather_kernel`: the same two
    channels from the flat (N, T, U*V) view, (2, N, U, T) fp32.
  * `scatter_bwd` stands for `_scatter_kernel`, the dense VJP
    ``ct_b * [v == blank] + ct_l * [v == lab]`` on (N, T, U, V).  That is
    `flat_kernels.flat_grad_write`'s function on the same memory, so it runs
    that kernel on a view and counts under ``flat_write``.

The first four are one kernel.  A column outside [0, C), or a label
outside [0, V), gives 0, in the kernel and in the plain versions alike.
(The JAX streaming kernel's masked sum gives 0 for a label at -1 or past
its padded V block, and sums the block's padding for one inside it; its
sparse kernel reads the neighbouring row's entry.)  On a CUDA
tensor the wrappers launch the kernel, or raise; on a CPU tensor they run
the plain versions beside them.  What bounds the kernel and what its design
does about it is noted at the top of `csrc/gather.cu`.

A wrapper's host path is kept short (`benchmarks/gather_host.py` times it
against one `torch.gather` call): the checks are one boolean expression
(the specific error is worked out only when it fails), the launch takes
one packed argument block (ctypes converts one argument, not eleven), the
stream is read raw, and the device context is entered only for a tensor
off the current device.

Not ported, by design: `_GATHER_MAX_COLS` (the JAX function splits K > 64
into several calls to fit the TPU's VMEM; one launch takes any K),
`gather_columns_supported` (C >= 128, the TPU's lane window) and
`_choose_blocks` (VMEM block sizes).
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from warp_rnnt_tpu_torch.ops import _build, flat_kernels
from warp_rnnt_tpu_torch.ops.packed_kernels import _DTYPE_CODES, _kernel_ready

# Launches per wrapper, counted where the kernel is launched and nowhere else.
LAUNCHES = {"gather_columns": 0, "gather_fwd": 0, "gather_fwd_sparse": 0,
            "gather_lattice": 0}

_THREADS = 256
_FRAMES = 8  # frames a kernel thread gathers (csrc/gather.cu kF)
# layout codes of rnnt_gather: the blank/label layouts, and the columns
_PLANAR_TU, _PLANAR_UT, _LATTICE, _COLUMNS = 0, 1, 2, 3
# rnnt_gather's argument block: xs, dtype, idx, out, N, frames, layout,
# K or U, C or V, blank, stream
_ARGS = struct.Struct("<11q")

_LIB: list = []  # the loaded library and its typed entry, held once
# The current stream's handle and the current device, read without
# building Python objects (absent from CPU-only builds, which never launch).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice", None)


def _entry():
    if not _LIB:
        lib = _build.load("gather")
        lib.rnnt_gather.argtypes = [ctypes.c_char_p]
        lib.rnnt_gather.restype = ctypes.c_int
        lib.rnnt_gather_error_string.argtypes = [ctypes.c_int]
        lib.rnnt_gather_error_string.restype = ctypes.c_char_p
        _LIB[:] = [lib, lib.rnnt_gather]
    return _LIB[1]


def _on_cpu(xs) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises."""
    if xs.is_cuda:
        return False
    if xs.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {xs.device}")


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


def _ready(xs, idx, layout, blank=0, V=0):
    """Every check of a CUDA launch of ``layout`` in one expression: xs
    (N, T, C) for the columns and the (N, U, T) layout, else (N, T, U, V),
    any float dtype, contiguous; idx (N, k) contiguous int32 on its device
    (cols, or labels_ext with k = U, C = U*V and blank in [0, V)); the grid
    within the kernel's 32 bits.  Only when it fails are the detailed
    checks run, for the error they raise.  Returns (K, device index), K the
    columns gathered a frame: k, or 2k for labels."""
    shape, ishape = xs.shape, idx.shape
    dev = xs.get_device()
    ndim = 4 if layout in (_PLANAR_TU, _LATTICE) else 3
    labels = layout != _COLUMNS
    ok = (len(shape) == ndim and len(ishape) == 2 and ishape[0] == shape[0]
          and xs.dtype in _DTYPE_CODES and idx.dtype == torch.int32
          and (not labels or 0 <= blank < V and ishape[1] * V == (
              shape[2] if ndim == 3 else shape[2] * shape[3]))
          and xs.is_contiguous() and idx.is_contiguous()
          and idx.get_device() == dev)
    if not ok:
        if labels:
            _check_labels(xs, ndim, idx, blank, V)
        else:
            _check(xs, ndim, idx, "cols", ishape[-1] if len(ishape) else -1)
        _kernel_ready((("xs", xs), ("index", idx)), xs.device)
        raise ValueError(f"xs {tuple(shape)} and index {tuple(ishape)}"
                         " do not fit the kernel")
    N, T, K = shape[0], shape[1], ishape[1] * (2 if labels else 1)
    if N * T * K >= 2**31:  # below, no grid limit can be reached
        groups = -(-T // _FRAMES) * K
        if N * -(-groups // _THREADS) >= 2**31 or groups >= 2**31:
            raise ValueError(f"{tuple(shape)} with {K} columns exceeds the"
                             " kernel's grid")
    return K, dev


def _run(xs, idx, layout, blank, V, counter):
    """Check, allocate and launch one layout of `rnnt_gather` on xs's
    device and current stream: (N, T, K) in xs's dtype for the columns,
    (2, N, T, U) and (2, N, U, T) fp32, the (N, T, U, 2) lattice in xs's
    dtype.  Raises on a launch error, else counts it under ``counter``."""
    K, dev = _ready(xs, idx, layout, blank, V)
    shape = xs.shape
    N, T, k = shape[0], shape[1], idx.shape[1]
    if layout == _COLUMNS:
        out, cv = xs.new_empty((N, T, K)), shape[2]
    elif layout == _LATTICE:
        out, cv = xs.new_empty((N, T, k, 2)), V
    else:
        out, cv = xs.new_empty((2, N, T, k) if layout == _PLANAR_TU
                               else (2, N, k, T), dtype=torch.float32), V
    if not (N and T and k):
        return out
    fn = _LIB[1] if _LIB else _entry()
    args = _ARGS.pack(xs.data_ptr(), _DTYPE_CODES[xs.dtype], idx.data_ptr(),
                      out.data_ptr(), N, T, layout, k, cv, blank,
                      _raw_stream(dev))
    if dev == _current_device():
        code = fn(args)
    else:
        with torch.cuda.device(dev):
            code = fn(args)
    if code:
        _build.check(_LIB[0], "rnnt_gather_error_string", code, "rnnt_gather")
    LAUNCHES[counter] += 1
    return out


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
    if _on_cpu(xs3):
        return gather_columns_flat_plain(xs3, cols)
    return _run(xs3, cols, _COLUMNS, 0, 0, "gather_columns")


def gather_lattice_plain(xs, labels_ext, blank: int):
    """Plain torch version of `gather_lattice`."""
    _check_labels(xs, 4, labels_ext, blank, xs.shape[-1])
    N, T, U, V = xs.shape
    valid = (labels_ext >= 0) & (labels_ext < V)
    idx = torch.where(valid, labels_ext, 0).long()[:, None, :, None]
    lab = torch.gather(xs, 3, idx.expand(N, T, U, 1))[..., 0]
    lab = torch.where(valid[:, None, :], lab, 0)
    return torch.stack([xs[..., blank], lab], dim=-1)


def gather_lattice(xs, labels_ext, blank: int):
    """xs (N, T, U, V) any float dtype, labels_ext (N, U) int32 (the last
    column the blank, as the loss builds it) -> the (N, T, U, 2) lattice in
    xs's dtype: channel 0 xs[..., blank], channel 1
    xs[n, t, u, labels_ext[n, u]], 0 where the label is outside [0, V).
    Values are moved, never rounded, so the lattice equals the main path's
    plain formulation (one `torch.gather` and a stack) bit for bit where
    the labels are in range (where one is not, `torch.gather` on the card
    stops with a device-side assert).  One launch; a CUDA tensor launches
    the kernel, a CPU tensor runs the plain version."""
    if _on_cpu(xs):
        return gather_lattice_plain(xs, labels_ext, blank)
    return _run(xs, labels_ext, _LATTICE, blank,
                xs.shape[-1] if xs.dim() else -1, "gather_lattice")


def gather_fwd_plain(xs, labels_ext, blank: int):
    """Plain torch version of `gather_fwd`."""
    lat = gather_lattice_plain(xs, labels_ext, blank)
    return lat.float().permute(3, 0, 1, 2).contiguous()


def gather_fwd(xs, labels_ext, blank: int):
    """xs (N, T, U, V) any float dtype, labels_ext (N, U) int32 (the last
    column the blank, as the loss builds it) -> (2, N, T, U) fp32:
    channel 0 xs[..., blank], channel 1 xs[n, t, u, labels_ext[n, u]], 0
    where the label is outside [0, V).  A CUDA tensor launches the kernel,
    a CPU tensor runs the plain version."""
    if _on_cpu(xs):
        return gather_fwd_plain(xs, labels_ext, blank)
    return _run(xs, labels_ext, _PLANAR_TU, blank,
                xs.shape[-1] if xs.dim() else -1, "gather_fwd")


def gather_fwd_sparse_plain(xs3, labels_ext, blank: int, V: int):
    """Plain torch version of `gather_fwd_sparse`."""
    _check_labels(xs3, 3, labels_ext, blank, V)
    N, T, _ = xs3.shape
    return gather_fwd_plain(xs3.reshape(N, T, -1, V), labels_ext,
                            blank).transpose(2, 3).contiguous()


def gather_fwd_sparse(xs3, labels_ext, blank: int, V: int):
    """The channels of `gather_fwd` from the flat view xs3 (N, T, U*V),
    laid out (2, N, U, T) fp32.  A CUDA tensor launches the kernel, a CPU
    tensor runs the plain version."""
    if _on_cpu(xs3):
        return gather_fwd_sparse_plain(xs3, labels_ext, blank, V)
    return _run(xs3, labels_ext, _PLANAR_UT, blank, V, "gather_fwd_sparse")


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
