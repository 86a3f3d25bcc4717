"""CUDA kernels of the compact (packed) layout's data movement
(`csrc/packed.cu`) and their plain torch versions (counterpart of
`warp_rnnt_tpu/ops/packed_kernels.py`).

In the packed layout, lattice cell (n, t, u) is row
``mem_pref[n] + t * (yn[n] + 1) + u`` of the (rows, V) log-probs, with
``mem_pref`` the exclusive prefix sum of ``xn * (yn + 1)``.  Rows past
``sum(xn * (yn + 1))`` are padding (a bucketed buffer).

  * `packed_gather_lattice` replaces the Pallas `_gather_kernel` and the
    stack of `packed_lattice`: packed (rows, V) log-probs, packed labels
    and the lengths -> the (N, T, U, 2) fp32 lattice the sweep reads, 0
    outside each lattice, plus the meta the backward reuses: ``loc``
    (`loc_rows`) and ``pref`` (`prefix_sums`).  One host call, two
    launches (a prefix scan, then the gather), no torch op on the lengths.
  * `packed_scatter` replaces the Pallas `_scatter_kernel`: the exact
    inverse for the backward, from the (N, T, U, 2) cotangent as it comes
    and the forward's meta: the dense two-nonzero gradient rows (channel 0
    at the blank, channel 1 at loc, added where loc == blank), pad rows 0.
  * `packed_lattice` is the differentiable pair: gather forward, scatter
    backward.

On a CUDA tensor the wrappers launch the kernels, or raise; on a CPU tensor
they run the plain versions beside them.  The kernels read the input dtype
and write the gradient in it, so a bf16 (rows, V) tensor is never copied to
fp32.  What bounds the kernels and what their design does about it is noted
at the top of `csrc/packed.cu`.  Each wrapper's host path is one check
expression (the specific error is worked out only when it fails), its
allocations and one ctypes call with a packed argument block.

Not ported, by design: `_choose_bt`, `_window_footprint`,
`movement_kernel_supported`, `_window_coords`, `_loc8` and `_host_meta`.  They
size DMA windows for the TPU's VMEM, its (8, 128) tiling and a one-hot MXU
permutation of the window rows; a GPU lane computes its own packed row, so
Hopper asks none of those questions and there is one route at every
(T, U, V).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from warp_rnnt_tpu_torch.ops import _build

# Kernel launches, counted where the kernels are launched and nowhere else
# (`packed_gather`: one C entry that launches two kernels, the prefix scan
# and the gather, so 2 a call).
LAUNCHES = {"packed_gather": 0, "packed_scatter": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                torch.bfloat16: 3}
# The argument blocks of rnnt_packed_lattice and rnnt_packed_scatter
# (`csrc/packed.cu` lists their entries).
_LATTICE_ARGS = struct.Struct("<16q")
_SCATTER_ARGS = struct.Struct("<14q")

_LIB: list = []  # the loaded library and its two typed entries, held once


def _entries():
    if not _LIB:
        lib = _build.load("packed")
        for fn in (lib.rnnt_packed_lattice, lib.rnnt_packed_scatter):
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
        lib.rnnt_packed_error_string.argtypes = [ctypes.c_int]
        lib.rnnt_packed_error_string.restype = ctypes.c_char_p
        _LIB[:] = [lib, lib.rnnt_packed_lattice, lib.rnnt_packed_scatter]
    return _LIB


def _call(i, args, dev, what):
    """Call entry i (1 lattice, 2 scatter) with a packed argument block on
    device ``dev``; raise on a launch error."""
    lib = _LIB if _LIB else _entries()
    code = _build.on_device(dev, lib[i], args)
    if code:
        _build.check(lib[0], "rnnt_packed_error_string", code, what)


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


def prefix_sums(xn, yn):
    """(2, N) int64: row 0 `mem_prefix`, row 1 each sample's first packed
    label (exclusive prefix sum of yn); what the gather kernel's scan
    writes."""
    yn64 = yn.long()
    return torch.stack([mem_prefix(xn, yn), torch.cumsum(yn64, 0) - yn64])


def _check(xn, yn, device, blank, V, T, U, loc=None):
    N = xn.shape[0]
    if N < 1 or min(T, U, V) < 1:
        raise ValueError(f"empty lattice (N, T, U, V) = {(N, T, U, V)}")
    if loc is not None and tuple(loc.shape) != (N, U):
        raise ValueError(f"loc_rows must have shape ({N}, {U}), got"
                         f" {tuple(loc.shape)}")
    if tuple(yn.shape) != (N,) or xn.dim() != 1:
        raise ValueError(f"xn and yn must be (N,), got {tuple(xn.shape)} and"
                         f" {tuple(yn.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")
    for name, x in (("loc_rows", loc), ("xn", xn), ("yn", yn)):
        if x is None:
            continue
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the data on {device}")


def _check_gather(xs, ys, xn, yn, blank, T, U):
    if xs.dim() != 2 or xs.dtype not in _DTYPE_CODES:
        raise ValueError(f"xs must be a 2-D float tensor (rows, V), got"
                         f" {tuple(xs.shape)} {xs.dtype}")
    if ys.dim() != 1 or ys.dtype != torch.int32 or ys.device != xs.device:
        raise ValueError(f"ys must be 1-D torch.int32 on {xs.device}, got"
                         f" {tuple(ys.shape)} {ys.dtype} on {ys.device}")
    _check(xn, yn, xs.device, blank, xs.shape[1], T, U)


def _check_scatter(ct, loc, pref, xn, yn, blank, V):
    if ct.dim() != 4 or ct.shape[3] != 2:
        raise ValueError(f"ct must be (N, T, U, 2), got {tuple(ct.shape)}")
    N, T, U, _ = ct.shape
    _check(xn, yn, ct.device, blank, V, T, U, loc)
    if tuple(pref.shape) != (2, N) or pref.dtype != torch.int64:
        raise ValueError(f"pref must be (2, {N}) torch.int64, got"
                         f" {tuple(pref.shape)} {pref.dtype}")


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


def packed_gather_lattice_plain(xs, ys, xn, yn, blank: int, T: int, U: int):
    """Plain torch version of `packed_gather_lattice`: (lattice (N, T, U, 2)
    fp32, loc (N, U) int32, pref (2, N) int64), NaN at valid cells whose
    row lies past the buffer or whose label lies outside [0, V)."""
    _check_gather(xs, ys, xn, yn, blank, T, U)
    N = xn.shape[0]
    rows, V = xs.shape
    loc = loc_rows(ys, xn, yn, U, blank)
    pos, valid = lattice_rows(xn, yn, T, U)
    lab = loc.long()[:, None, :].expand(N, T, U)
    bad = valid & ((pos >= rows) | (lab < 0) | (lab >= V))
    ok = valid & ~bad
    lat = torch.zeros((N, T, U, 2), dtype=torch.float32, device=xs.device)
    if rows:
        p = torch.where(ok, pos, 0)
        pair = torch.stack([xs[p, blank], xs[p, torch.where(ok, lab, 0)]], -1)
        lat = torch.where(ok[..., None], pair.float(), lat)
    lat = torch.where(bad[..., None], float("nan"), lat)
    return lat, loc, prefix_sums(xn, yn)


def packed_gather_lattice(xs, ys, xn, yn, blank: int, T: int, U: int):
    """packed (rows, V) log-probs, packed labels ys (sum(yn),) int32 and the
    lengths xn, yn (N,) int32 -> (lattice, loc, pref):

      * lattice (N, T, U, 2) fp32: channel 0 the blank's log-prob, channel
        1 the next label's (``loc[n, u]``), at packed row
        ``pref[0, n] + t * (yn + 1) + u``; 0 at cells with t >= xn or
        u > yn; NaN where that row lies past the buffer or the label
        outside [0, V);
      * loc (N, U) int32, `loc_rows`; pref (2, N) int64, `prefix_sums`:
        the meta `packed_scatter` reads.

    xs: any float dtype, read in that dtype.  T, U: the lattice bounds (at
    least max(xn) and max(yn) + 1; the caller checks them).  A CUDA tensor
    launches the kernels (a prefix scan, then the gather: two launches, one
    host call), a CPU tensor runs `packed_gather_lattice_plain`.
    """
    if _build.on_cpu(xs):
        return packed_gather_lattice_plain(xs, ys, xn, yn, blank, T, U)
    N = xn.shape[0]
    dev = xs.get_device()
    ok = (xs.dim() == 2 and xs.dtype in _DTYPE_CODES and ys.dim() == 1
          and ys.dtype == xn.dtype == yn.dtype == torch.int32
          and xn.dim() == 1 and yn.shape == xn.shape and N >= 1
          and T >= 1 and U >= 1 and 0 <= blank < xs.shape[1]
          and xs.is_contiguous() and ys.is_contiguous()
          and xn.is_contiguous() and yn.is_contiguous()
          and ys.get_device() == xn.get_device() == yn.get_device() == dev
          and N * T < 2**31)
    if not ok:  # the checks that name the fault
        _check_gather(xs, ys, xn, yn, blank, T, U)
        _kernel_ready((("xs", xs), ("ys", ys), ("xn", xn), ("yn", yn)),
                      xs.device)
        if N * T >= 2**31:
            raise ValueError(f"{N} x {T} frames exceed the kernel's grid")
        raise ValueError("invalid arguments to the packed gather kernel")
    out = torch.empty((N, T, U, 2), dtype=torch.float32, device=xs.device)
    pref = torch.empty((2, N), dtype=torch.int64, device=xs.device)
    loc = torch.empty((N, U), dtype=torch.int32, device=xs.device)
    rows, V = xs.shape
    _call(1, _LATTICE_ARGS.pack(
        xs.data_ptr(), _DTYPE_CODES[xs.dtype], ys.data_ptr(), ys.shape[0],
        xn.data_ptr(), yn.data_ptr(), pref.data_ptr(), loc.data_ptr(),
        out.data_ptr(), N, T, U, V, blank, rows, _build.raw_stream(dev)),
        dev, "rnnt_packed_lattice")
    LAUNCHES["packed_gather"] += 2  # the prefix scan and the gather
    return out, loc, pref


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


def packed_scatter_plain(ct, loc, pref, xn, yn, blank: int, rows: int, V: int,
                         out_dtype=torch.float32):
    """Plain torch version of `packed_scatter`."""
    _check_scatter(ct, loc, pref, xn, yn, blank, V)
    T, U = ct.shape[1], ct.shape[2]
    n, t, u, valid = row_coordinates(rows, xn, yn)
    c = ct[n, t.clamp(0, T - 1), u.clamp(0, U - 1)]
    c0 = torch.where(valid, c[:, 0], 0.0)[:, None]
    c1 = torch.where(valid, c[:, 1], 0.0)[:, None]
    v = torch.arange(V, device=ct.device)
    d = c0 * (v == blank) + c1 * (v == loc.long()[n, u.clamp(0, U - 1)][:, None])
    return d.to(out_dtype)


def packed_scatter(ct, loc, pref, xn, yn, blank: int, rows: int, V: int,
                   out_dtype=torch.float32):
    """The (N, T, U, 2) fp32 cotangent of `packed_gather_lattice`'s lattice,
    with the forward's ``loc`` and ``pref`` -> the packed (rows, V)
    gradient in ``out_dtype``: row r of cell (n, t, u) holds ct[..., 0] at
    the blank and ct[..., 1] at loc[n, u] (their sum where loc == blank);
    rows past sum(xn * (yn + 1)) are 0.  The exact inverse of the
    gather's extraction.  ct is read as it is, interleaved.  A CUDA tensor
    launches the kernel, a CPU tensor runs `packed_scatter_plain`.
    """
    if _build.on_cpu(ct):
        return packed_scatter_plain(ct, loc, pref, xn, yn, blank, rows, V,
                                    out_dtype)
    _check_scatter(ct, loc, pref, xn, yn, blank, V)
    N, T, U, _ = ct.shape
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if ct.dtype != torch.float32:
        raise ValueError(f"ct must be float32, got {ct.dtype}")
    _kernel_ready((("ct", ct), ("loc_rows", loc), ("pref", pref), ("xn", xn),
                   ("yn", yn)), ct.device)
    if pref.device != ct.device:
        raise ValueError(f"pref is on {pref.device}, the data on {ct.device}")
    if U * V >= 2**31 or N * T + 1024 >= 2**31:
        raise ValueError(f"(N, T, U, V) = {(N, T, U, V)} exceeds the kernel's"
                         " 32-bit frame span or grid")
    out = torch.empty((rows, V), dtype=out_dtype, device=ct.device)
    if rows == 0:
        return out
    dev = ct.get_device()
    _call(2, _SCATTER_ARGS.pack(
        ct.data_ptr(), loc.data_ptr(), xn.data_ptr(), yn.data_ptr(),
        pref.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype], N, T, U, V,
        blank, rows, _build.raw_stream(dev)), dev, "rnnt_packed_scatter")
    LAUNCHES["packed_scatter"] += 1
    return out


class _PackedLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, ys, xn, yn, blank, T, U):
        lat, loc, pref = packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
        ctx.save_for_backward(loc, pref, xn, yn)
        ctx.meta = (blank, xs.shape[0], xs.shape[1], xs.dtype)
        return lat

    @staticmethod
    def backward(ctx, ct):
        loc, pref, xn, yn = ctx.saved_tensors
        blank, rows, V, dtype = ctx.meta
        d = packed_scatter(ct.float().contiguous(), loc, pref, xn, yn, blank,
                           rows, V, dtype)
        return d, None, None, None, None, None, None


def packed_lattice(xs, ys, xn, yn, blank: int, T: int, U: int):
    """Differentiable packed (rows, V) -> gathered (N, T, U, 2) lattice:
    `packed_gather_lattice` forward, `packed_scatter` backward on its meta
    (the gradient in the input dtype, pad rows 0)."""
    return _PackedLattice.apply(xs, ys, xn, yn, blank, T, U)
