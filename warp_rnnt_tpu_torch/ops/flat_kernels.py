"""CUDA dense gradient write (`csrc/flat_write.cu`) and its plain torch twin
(counterpart of `warp_rnnt_tpu/ops/flat_kernels.py`).

`flat_grad_write` replaces the Pallas `_flat_write_kernel`:

    d[n, t, u*V + v] = ct0[n, t, u] * [v == blank] + ct1[n, t, u] * [v == loc]

with the label index frame-invariant (`loc = loc_rows[n, u]`).  Where
`loc == blank` both terms add.  With a column ``offset`` the output is the
block [offset, offset + V) of a wider vocabulary whose indices the blank and
``loc_rows`` are: a blank or label outside the block writes nothing, in the
kernel (its compare never matches) and in the plain twin alike (the
backward of `parallel.vocab`'s sharded gather).  A contiguous
(N, T, U, V) tensor is the same memory as (N, T, U*V), so the 4-D backward
of the gather uses this writer too, on a view.  On a CUDA tensor it
launches the kernel, or raises; on a CPU tensor it runs
`flat_grad_write_plain`.  The cotangents may be two (N, T, U) planes or the
two channels of one contiguous (N, T, U, 2) fp32 cotangent (``ct[..., 0]``,
``ct[..., 1]``), which the kernel reads in place, a row's two as one 8-byte
load (`_build.elem_stride`).

The kernel tiles the flat (rows * V) output by rows: a block takes R
consecutive rows (about 32 KB of output, 1 to 1024 rows, so many short
rows share a block and a 5000-column row is a block of its own), stages
their cotangents and labels in shared memory and stores its span as
16-byte vectors in every output dtype, a vector's elements taking their
own rows' coefficients where it straddles two rows.  The rule for R lives
in the C source alone; `kernel_block_rows` reads it from the built
library.  What bounds the kernel and what its design does about that is
noted at the top of `csrc/flat_write.cu`.
"""

from __future__ import annotations

import ctypes

import torch

from warp_rnnt_tpu_torch.ops import _build

# Launches of the kernel, counted where it is launched and nowhere else.
LAUNCHES = {"flat_write": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                torch.bfloat16: 3}


def _lib():
    lib = _build.load("flat_write")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_flat_grad_write.argtypes = [p, p, i, p, p, i,
                                             ctypes.c_longlong, i, i, i, i, p]
        lib.rnnt_flat_grad_write.restype = i
        lib.rnnt_flat_write_block_rows.argtypes = [i, i]
        lib.rnnt_flat_write_block_rows.restype = i
        lib.rnnt_flat_write_error_string.argtypes = [i]
        lib.rnnt_flat_write_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def kernel_block_rows(V: int, out_dtype=torch.float32) -> int:
    """Rows a block of the kernel takes for V columns of ``out_dtype``, as
    the C entry computes them (builds the library on first use)."""
    return _lib().rnnt_flat_write_block_rows(V, _DTYPE_CODES[out_dtype])


def _check(ct0, ct1, loc_rows, blank, V, UV, out_dtype, offset=None,
           out=None):
    if ct0.dim() != 3 or ct1.shape != ct0.shape:
        raise ValueError(
            f"ct0 and ct1 must be (N, T, U) of one shape, got"
            f" {tuple(ct0.shape)} and {tuple(ct1.shape)}"
        )
    N, T, U = ct0.shape
    if loc_rows.shape != (N, U):
        raise ValueError(
            f"loc_rows must have shape ({N}, {U}), got {tuple(loc_rows.shape)}"
        )
    if UV != U * V:
        raise ValueError(f"UV={UV} != U*V={U}*{V}")
    if offset is None and not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")
    if offset is not None and not 0 <= min(blank, offset):
        raise ValueError(f"blank={blank} and offset={offset} must be >= 0")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    for name, x, dtype in (("ct0", ct0, torch.float32),
                           ("ct1", ct1, torch.float32),
                           ("loc_rows", loc_rows, torch.int32)):
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != ct0.device:
            raise ValueError(f"{name} is on {x.device}, ct0 on {ct0.device}")
    if out is not None and (tuple(out.shape) != (N, T, UV)
                            or out.dtype != out_dtype
                            or out.device != ct0.device
                            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous ({N}, {T}, {UV}) {out_dtype} tensor on"
            f" {ct0.device}, got {tuple(out.shape)} {out.dtype} on"
            f" {out.device}{'' if out.is_contiguous() else ', strided'}")


def flat_grad_write_plain(ct0, ct1, loc_rows, blank: int, V: int, UV: int,
                          out_dtype=torch.float32, offset=None, out=None):
    """Plain torch twin: the compare-select of `gather._gather_flat_bwd`,
    copied into ``out`` where one is given."""
    _check(ct0, ct1, loc_rows, blank, V, UV, out_dtype, offset, out)
    N, T, U = ct0.shape
    v_iota = torch.arange(offset or 0, (offset or 0) + V, device=ct0.device)
    d = ct0[..., None] * (v_iota == blank) + ct1[..., None] * (
        v_iota == loc_rows[:, None, :, None]
    )
    d = d.reshape(N, T, UV).to(out_dtype)
    return d if out is None else out.copy_(d)


def flat_grad_write(ct0, ct1, loc_rows, blank: int, V: int, UV: int,
                    out_dtype=torch.float32, offset=None, out=None):
    """(N, T, U) fp32 blank/label cotangents -> (N, T, U*V) gradient.

    loc_rows: (N, U) int32 frame-invariant label indices.  With a column
    ``offset`` the output is the block [offset, offset + V) (see the
    module docstring).  The output is ``out`` where one is given (a
    contiguous (N, T, U*V) tensor of ``out_dtype`` on ct0's device: a
    compiled step's donated log-probs, `functional.gather`), else allocated
    here with `torch.empty`; the kernel writes every element.  The grid
    has ceil(rows / R) blocks (R = `kernel_block_rows`), which stays under
    CUDA's 2**31 - 1 for any output a card can hold; past it the C entry
    refuses the launch and this raises.
    """
    if ct0.device.type == "cpu":
        return flat_grad_write_plain(ct0, ct1, loc_rows, blank, V, UV,
                                     out_dtype, offset, out)
    _check(ct0, ct1, loc_rows, blank, V, UV, out_dtype, offset, out)
    if offset:
        loc_rows, blank = (loc_rows - offset).contiguous(), blank - offset
    if ct0.device.type != "cuda":
        raise ValueError(f"unsupported device {ct0.device}")
    if not loc_rows.is_contiguous():
        raise ValueError("loc_rows must be contiguous")
    stride = _build.elem_stride(ct0, "ct0")
    if _build.elem_stride(ct1, "ct1") != stride:
        raise ValueError("ct0 and ct1 must have one element stride")
    N, T, U = ct0.shape
    rows = N * T * U
    if out is None:
        out = torch.empty((N, T, UV), dtype=out_dtype, device=ct0.device)
    if rows == 0 or V == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(ct0.device).cuda_stream
    with torch.cuda.device(ct0.device):
        code = lib.rnnt_flat_grad_write(
            ct0.data_ptr(), ct1.data_ptr(), stride, loc_rows.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], rows, T, U, V, blank,
            stream,
        )
    _build.check(lib, "rnnt_flat_write_error_string", code, "rnnt_flat_grad_write")
    LAUNCHES["flat_write"] += 1
    return out
