"""CUDA kernels of the compact (packed) layout's data movement
(`csrc/packed.cu`) and their plain torch versions (counterpart of
`warp_rnnt_tpu/ops/packed_kernels.py`).

In the packed layout, lattice cell (n, t, u) is row
``mem_pref[n] + t * (yn[n] + 1) + u`` of the (rows, V) log-probs, with
``mem_pref`` the exclusive prefix sum of ``xn * (yn + 1)``.  Rows past
``sum(xn * (yn + 1))`` are padding (a bucketed buffer).

  * `packed_gather` replaces the Pallas `_gather_kernel`: packed (rows, V)
    -> blank and emit lattices (N, T, U) fp32, 0 outside each lattice.
  * `packed_scatter` replaces the Pallas `_scatter_kernel`: the exact
    inverse for the backward, the dense two-nonzero gradient rows (ct0 at
    the blank, ct1 at loc, added where loc == blank), pad rows 0.
  * `packed_lattice` is the differentiable pair: gather forward, scatter
    backward.

On a CUDA tensor the wrappers launch the kernels, or raise; on a CPU tensor
they run the plain versions beside them.  The kernels read the input dtype
and write the gradient in it, so a bf16 (rows, V) tensor is never copied to
fp32.  What bounds the kernels and what their design does about it is noted
at the top of `csrc/packed.cu`.

Not ported, by design: `_choose_bt`, `_window_footprint`,
`movement_kernel_supported`, `_window_coords`, `_loc8` and `_host_meta`.  They
size DMA windows for the TPU's VMEM, its (8, 128) tiling and a one-hot MXU
permutation of the window rows; a GPU thread computes its own packed row, so
Hopper asks none of those questions and there is one route at every
(T, U, V).
"""

from __future__ import annotations

import ctypes

import torch

from warp_rnnt_tpu_torch.ops import _build

# Launches per kernel, counted where the kernel is launched and nowhere else.
LAUNCHES = {"packed_gather": 0, "packed_scatter": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                torch.bfloat16: 3}


def _lib():
    lib = _build.load("packed")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnnt_packed_gather.argtypes = [p, i] + [p] * 6 + [i] * 5 + [ll, p]
        lib.rnnt_packed_scatter.argtypes = [p] * 7 + [i] * 6 + [ll, p]
        lib.rnnt_packed_gather.restype = i
        lib.rnnt_packed_scatter.restype = i
        lib.rnnt_packed_error_string.argtypes = [i]
        lib.rnnt_packed_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def loc_rows(ys, xn, yn, U: int, blank: int):
    """Per-sample row labels (N, U) int32: row u's emit channel reads
    ``ys[label_pref[n] + u]`` for u < yn[n] and the blank from u == yn[n]
    on (also with ``ys`` empty).  ys: packed labels (sum(yn),)."""
    N = xn.shape[0]
    yn = yn.long()
    u_io = torch.arange(U, device=yn.device)[None, :]
    if ys.shape[0] == 0:
        nxt = torch.full((N, U), blank, dtype=torch.int32, device=yn.device)
    else:
        label_pref = torch.cumsum(yn, 0) - yn
        pos = (label_pref[:, None] + u_io).clamp(0, ys.shape[0] - 1)
        nxt = ys.to(torch.int32)[pos]
    return torch.where(u_io < yn[:, None], nxt, blank).to(torch.int32).contiguous()


def mem_prefix(xn, yn):
    """(N,) int64 first packed row of each sample (exclusive prefix sum of
    xn * (yn + 1)), on the lengths' device, without a host sync."""
    sizes = xn.long() * (yn.long() + 1)
    return (torch.cumsum(sizes, 0) - sizes).contiguous()


def _check(loc, xn, yn, device, blank, V, T, U):
    N = xn.shape[0]
    if N < 1 or min(T, U, V) < 1:
        raise ValueError(f"empty lattice (N, T, U, V) = {(N, T, U, V)}")
    if tuple(loc.shape) != (N, U):
        raise ValueError(f"loc_rows must have shape ({N}, {U}), got"
                         f" {tuple(loc.shape)}")
    if tuple(yn.shape) != (N,) or xn.dim() != 1:
        raise ValueError(f"xn and yn must be (N,), got {tuple(xn.shape)} and"
                         f" {tuple(yn.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")
    for name, x in (("loc_rows", loc), ("xn", xn), ("yn", yn)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the data on {device}")


def _kernel_ready(tensors, device):
    """The CUDA-only checks: device type, contiguity, 32-bit grid sizes."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lattice_rows(xn, yn, T: int, U: int):
    """(N, T, U) packed row of every lattice cell and its validity
    (t < xn, u <= yn); the inverse map of `row_coordinates`."""
    t_io = torch.arange(T, device=xn.device)[None, :, None]
    u_io = torch.arange(U, device=xn.device)[None, None, :]
    xn_b, yn_b = xn.long()[:, None, None], yn.long()[:, None, None]
    pos = mem_prefix(xn, yn)[:, None, None] + t_io * (yn_b + 1) + u_io
    return pos, (t_io < xn_b) & (u_io <= yn_b)


def packed_gather_plain(xs, loc, xn, yn, blank: int, T: int, U: int):
    """Plain torch version of `packed_gather`: (blank_col, emit_col) (N, T, U)
    fp32, 0 outside each lattice."""
    _check(loc, xn, yn, xs.device, blank, xs.shape[1], T, U)
    N = xn.shape[0]
    pos, valid = lattice_rows(xn, yn, T, U)
    pos = torch.where(valid, pos, 0)
    b = xs[pos, blank].float()
    e = xs[pos, loc.long()[:, None, :].expand(N, T, U)].float()
    return torch.where(valid, b, 0.0), torch.where(valid, e, 0.0)


def packed_gather(xs, loc, xn, yn, blank: int, T: int, U: int):
    """packed (rows, V) + loc_rows (N, U) -> (blank_col, emit_col) (N, T, U)
    fp32, 0 at cells with t >= xn or u > yn.

    xs: any float dtype, read in that dtype.  T, U: the lattice bounds (at
    least max(xn) and max(yn) + 1; the caller checks them).  A CUDA tensor
    launches the kernel, a CPU tensor runs `packed_gather_plain`.
    """
    if xs.device.type == "cpu":
        return packed_gather_plain(xs, loc, xn, yn, blank, T, U)
    if xs.dim() != 2 or xs.dtype not in _DTYPE_CODES:
        raise ValueError(f"xs must be a 2-D float tensor (rows, V), got"
                         f" {tuple(xs.shape)} {xs.dtype}")
    rows, V = xs.shape
    _check(loc, xn, yn, xs.device, blank, V, T, U)
    _kernel_ready((("xs", xs), ("loc_rows", loc), ("xn", xn), ("yn", yn)),
                  xs.device)
    N = xn.shape[0]
    if -(-N * T * U // 256) >= 2**31:
        raise ValueError(f"{N * T * U} lattice cells exceed the kernel's grid")
    mem_pref = mem_prefix(xn, yn)
    blank_col = torch.empty((N, T, U), dtype=torch.float32, device=xs.device)
    emit_col = torch.empty_like(blank_col)
    lib = _lib()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        code = lib.rnnt_packed_gather(
            xs.data_ptr(), _DTYPE_CODES[xs.dtype], loc.data_ptr(),
            xn.data_ptr(), yn.data_ptr(), mem_pref.data_ptr(),
            blank_col.data_ptr(), emit_col.data_ptr(), N, T, U, V, blank,
            rows, stream,
        )
    _build.check(lib, "rnnt_packed_error_string", code, "rnnt_packed_gather")
    LAUNCHES["packed_gather"] += 1
    return blank_col, emit_col


def row_coordinates(rows: int, xn, yn):
    """Packed row id -> (n, t, u) int64, and the (rows,) bool mask of rows
    below sum(xn * (yn + 1)); pad rows map onto the last sample, clamped."""
    sizes = xn.long() * (yn.long() + 1)
    cumlen = torch.cumsum(sizes, 0)
    r = torch.arange(rows, device=xn.device)
    n = torch.searchsorted(cumlen, r, right=True).clamp(max=xn.shape[0] - 1)
    within = r - (cumlen - sizes)[n]
    stride = yn.long()[n] + 1
    t = torch.div(within, stride, rounding_mode="floor")
    return n, t, within - t * stride, r < cumlen[-1]


def packed_scatter_plain(ct0, ct1, loc, xn, yn, blank: int, rows: int, V: int,
                         out_dtype=torch.float32):
    """Plain torch version of `packed_scatter`."""
    N, T, U = ct0.shape
    _check(loc, xn, yn, ct0.device, blank, V, T, U)
    n, t, u, valid = row_coordinates(rows, xn, yn)
    t, u = t.clamp(0, T - 1), u.clamp(0, U - 1)
    c0 = torch.where(valid, ct0[n, t, u], 0.0)[:, None]
    c1 = torch.where(valid, ct1[n, t, u], 0.0)[:, None]
    v = torch.arange(V, device=ct0.device)
    d = c0 * (v == blank) + c1 * (v == loc.long()[n, u][:, None])
    return d.to(out_dtype)


def packed_scatter(ct0, ct1, loc, xn, yn, blank: int, rows: int, V: int,
                   out_dtype=torch.float32):
    """(N, T, U) fp32 blank/emit cotangents -> packed (rows, V) gradient in
    ``out_dtype``: row r of cell (n, t, u) holds ct0 at the blank and ct1
    at loc_rows[n, u] (their sum where loc == blank); rows past
    sum(xn * (yn + 1)) are 0.  The exact inverse of `packed_gather`'s
    extraction.  A CUDA tensor launches the kernel, a CPU tensor runs
    `packed_scatter_plain`.
    """
    if ct0.device.type == "cpu":
        return packed_scatter_plain(ct0, ct1, loc, xn, yn, blank, rows, V,
                                    out_dtype)
    if ct0.dim() != 3 or ct1.shape != ct0.shape:
        raise ValueError(f"ct0 and ct1 must be (N, T, U) of one shape, got"
                         f" {tuple(ct0.shape)} and {tuple(ct1.shape)}")
    N, T, U = ct0.shape
    _check(loc, xn, yn, ct0.device, blank, V, T, U)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    for name, x in (("ct0", ct0), ("ct1", ct1)):
        if x.dtype != torch.float32 or x.device != ct0.device:
            raise ValueError(f"{name} must be float32 on {ct0.device}")
    _kernel_ready((("ct0", ct0), ("ct1", ct1), ("loc_rows", loc), ("xn", xn),
                   ("yn", yn)), ct0.device)
    if U * V >= 2**31 or N * T + 1024 >= 2**31:
        raise ValueError(f"(N, T, U, V) = {(N, T, U, V)} exceeds the kernel's"
                         " 32-bit frame span or grid")
    out = torch.empty((rows, V), dtype=out_dtype, device=ct0.device)
    if rows == 0:
        return out
    mem_pref = mem_prefix(xn, yn)
    lib = _lib()
    stream = torch.cuda.current_stream(ct0.device).cuda_stream
    with torch.cuda.device(ct0.device):
        code = lib.rnnt_packed_scatter(
            ct0.data_ptr(), ct1.data_ptr(), loc.data_ptr(), xn.data_ptr(),
            yn.data_ptr(), mem_pref.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[out_dtype], N, T, U, V, blank, rows, stream,
        )
    _build.check(lib, "rnnt_packed_error_string", code, "rnnt_packed_scatter")
    LAUNCHES["packed_scatter"] += 1
    return out


class _PackedLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, loc, xn, yn, blank, T, U):
        b, e = packed_gather(xs, loc, xn, yn, blank, T, U)
        ctx.save_for_backward(loc, xn, yn)
        ctx.meta = (blank, xs.shape[0], xs.shape[1], xs.dtype)
        return torch.stack([b, e], dim=-1)

    @staticmethod
    def backward(ctx, ct):
        loc, xn, yn = ctx.saved_tensors
        blank, rows, V, dtype = ctx.meta
        ct = ct.float()
        d = packed_scatter(ct[..., 0].contiguous(), ct[..., 1].contiguous(), loc,
                           xn, yn, blank, rows, V, dtype)
        return d, None, None, None, None, None, None


def packed_lattice(xs, loc, xn, yn, blank: int, T: int, U: int):
    """Differentiable packed (rows, V) -> gathered (N, T, U, 2) lattice:
    `packed_gather` forward, `packed_scatter` backward (the gradient in the
    input dtype, pad rows 0)."""
    return _PackedLattice.apply(xs, loc, xn, yn, blank, T, U)
