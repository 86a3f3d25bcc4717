"""CUDA lattice kernel (`csrc/lattice.cu`) and its plain torch twin
(counterpart of `warp_rnnt_tpu/ops/pallas_impl.py`).

`alpha_beta` replaces the Pallas `_fused_kernel` (``compute_alpha=True``) and
`_beta_only_kernel` (``compute_alpha=False``).  On a CUDA tensor it launches
the kernel, a warp pipeline over the lattice whose frames a lane and warps
`lattice_plan` gives, or raises; on a CPU tensor it runs `alpha_beta_plain`,
the torch twin: the same recurrence with the same -1e30 sentinel, each
column solved in the kernel's order (`_solve`) with the kernel's
logaddexp.  On the card the two agree to the rounding of the same
operations; `alpha_beta_plain(..., dtype=torch.float64)` is the reference
that holds long lattices to what float32 can give.  Invalid cells hold
values near the sentinel in both; only valid cells (t < xn, u <= yn) are
meaningful.

The lattice reads blank and emit at an element stride (`_build.elem_stride`):
two (N, T, U) planes, or the two channels of the interleaved (N, T, U, 2)
fp32 lattice that the gather writes, read in place with no de-interleave
copy.

`epilogue` is the post-sweep epilogue, everything
`functional/postprocess.costs_and_grads` computes (costs, the canary's mask,
both gradients with FastEmit and the canary's zeroing), in one launch of
`epilogue_kernel` (`csrc/lattice.cu`), written to strided outputs in any
float dtype: two fp32 planes, or the channels of the (N, T, U, 2) gradient
in the input's dtype, so the core needs no stack and no cast.  In JAX that
code is XLA's fusion around the Pallas sweep.  `epilogue_plain` is that
torch code written to the same outputs; the two agree bit for bit.  The
main path runs `forward_backward_gathered`: the sweep on the lattice in
place, then the epilogue into the (N, T, U, 2) gradient.

What bounds the kernels and what their design does about that is noted in
`csrc/lattice.cu`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from warp_rnnt_tpu_torch.functional.postprocess import (
    costs_grads_mask,
    warn_mismatch,
)
from warp_rnnt_tpu_torch.ops import _build

NEG = -1.0e30

# Launches per kernel, counted where the kernel is launched and nowhere else.
LAUNCHES = {"lattice_fused": 0, "lattice_beta_only": 0, "lattice_epilogue": 0}

# The epilogue's output dtypes, as the C entry numbers them.
_OUT_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}


def _lib():
    lib = _build.load("lattice")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lattice.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p, i, i]
        lib.rnnt_lattice.restype = i
        lib.rnnt_lattice_epilogue.argtypes = [p, p, i, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, ctypes.c_float, p]
        lib.rnnt_lattice_epilogue.restype = i
        lib.rnnt_lattice_attrs.argtypes = [i, i, i, p]
        lib.rnnt_lattice_attrs.restype = i
        lib.rnnt_lae_probe.argtypes = [p, i, p]
        lib.rnnt_lae_probe.restype = i
        lib.rnnt_lattice_error_string.argtypes = [i]
        lib.rnnt_lattice_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


MAX_FRAMES = 8    # scan positions a lane
MAX_WARPS = 32


class LatticePlan(NamedTuple):
    """The kernel's order for a lattice of T frames: each of `warps` warps
    owns 32 * `frames` consecutive scan positions, and `segments` sweeps of
    warps * 32 * frames positions cover T."""
    frames: int
    warps: int
    segments: int


@functools.lru_cache(maxsize=256)
def lattice_plan(T: int) -> LatticePlan:
    """Frames a lane ceil(T / 1024) (at most 8), and as few warps as cover
    T (at most 32)."""
    if T < 1:
        raise ValueError(f"empty lattice T={T}")
    frames = min(MAX_FRAMES, -(-T // (32 * MAX_WARPS)))
    warps = min(MAX_WARPS, -(-T // (32 * frames)))
    segments = -(-T // (32 * frames * warps))
    return LatticePlan(frames, warps, segments)


def _check(blank_lp, emit_lp, xn, yn):
    if blank_lp.dim() != 3:
        raise ValueError(f"blank_lp must be (N, T, U), got {tuple(blank_lp.shape)}")
    N, T, U = blank_lp.shape
    if min(N, T, U) < 1:
        raise ValueError(f"empty lattice {tuple(blank_lp.shape)}")
    if emit_lp.shape != blank_lp.shape:
        raise ValueError(
            f"emit_lp shape {tuple(emit_lp.shape)} != blank_lp shape"
            f" {tuple(blank_lp.shape)}"
        )
    for name, x in (("xn", xn), ("yn", yn)):
        if x.shape != (N,):
            raise ValueError(f"{name} must have shape ({N},), got {tuple(x.shape)}")
    for name, x in (("emit_lp", emit_lp), ("xn", xn), ("yn", yn)):
        if x.device != blank_lp.device:
            raise ValueError(
                f"{name} is on {x.device}, blank_lp on {blank_lp.device}"
            )


def _shift_right(x, k, fill):
    """x[..., t-k] along the last axis, `fill` where t < k."""
    pad = x.new_full(x.shape[:-1] + (min(k, x.shape[-1]),), fill)
    return torch.cat([pad, x[..., : x.shape[-1] - k]], dim=-1)


def _lae(a, b):
    """logaddexp on finite sentinel values (never sees true -inf: the
    log-probs are read through `_floor`)."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _floor(x):
    """Log-probs below the sentinel (-inf among them) read as the sentinel,
    as the kernel's loads do; finite values at or above it and NaN pass
    unchanged.  Without it a cell whose blank and label are both -inf gives
    ``|a - b|`` = NaN in `_lae`, where the JAX scan stays finite."""
    return torch.where(x < NEG, NEG, x)


def _solve(m, b):
    """Inclusive solve of a[j] = LSE(a[j-1] + m[j], b[j]) along the last
    axis of (N, T), in the kernel's order for `lattice_plan(T)`: each lane
    folds its `frames` positions, a 32-lane doubling scan combines the
    lanes' (m, b) pairs (the combine of `pallas_impl._scan_fwd`), the carry
    of the warp before seeds each warp, and the last value of the segment
    before seeds each segment's first warp."""
    N, T = m.shape
    K, W, S = lattice_plan(T)
    pad = S * W * 32 * K - T
    m = torch.nn.functional.pad(m, (0, pad), value=0.0).view(N, S, W, 32, K)
    b = torch.nn.functional.pad(b, (0, pad), value=NEG).view(N, S, W, 32, K)
    pm, pb = [m[..., 0]], [b[..., 0]]
    for i in range(1, K):
        pb.append(_lae(pb[-1] + m[..., i], b[..., i]))
        pm.append(pm[-1] + m[..., i])
    M, B = pm[-1], pb[-1]
    for d in (1, 2, 4, 8, 16):
        ms, bs = _shift_right(M, d, 0.0), _shift_right(B, d, NEG)
        B = _lae(bs + M, B)
        M = ms + M
    me, be = _shift_right(M, 1, 0.0), _shift_right(B, 1, NEG)
    out = []
    last = m.new_full((N,), NEG)
    for s in range(S):
        cin = [last]
        for w in range(1, W):
            cin.append(_lae(cin[-1] + M[:, s, w - 1, 31], B[:, s, w - 1, 31]))
        ain = _lae(torch.stack(cin, 1)[..., None] + me[:, s], be[:, s])
        seg = torch.stack([_lae(ain + pm[i][:, s], pb[i][:, s])
                           for i in range(K)], -1)
        last = seg[:, -1, -1, -1]
        out.append(seg.reshape(N, -1))
    return torch.cat(out, 1)[:, :T]


def alpha_beta_plain(blank_lp, emit_lp, xn, yn, compute_alpha: bool = True,
                     dtype=torch.float32):
    """Plain torch twin of the lattice kernel: (alphas or None, betas), in
    `dtype` (float64 holds long lattices, where float32's own rounding nears
    the kernel check's tolerance)."""
    _check(blank_lp, emit_lp, xn, yn)
    blank_lp = _floor(blank_lp.to(dtype))
    emit_lp = _floor(emit_lp.to(dtype))
    N, T, U = blank_lp.shape
    t_iota = torch.arange(T, device=blank_lp.device)[None, :]
    xn = xn[:, None]
    yn = yn[:, None]
    valid_t = t_iota < xn
    terminal_t = t_iota == xn - 1

    betas = [None] * U
    carry = blank_lp.new_full((N, T), NEG)
    for u in range(U - 1, -1, -1):
        blank_col = blank_lp[:, :, u]
        b = torch.where(
            terminal_t & (u == yn),
            blank_col,
            torch.where((u < yn) & valid_t, emit_lp[:, :, u] + carry, NEG),
        )
        carry = torch.flip(
            _solve(torch.flip(blank_col, (1,)), torch.flip(b, (1,))), (1,)
        )
        betas[u] = carry
    betas = torch.stack(betas, dim=2)
    if not compute_alpha:
        return None, betas

    alphas = []
    seed = torch.where(t_iota == 0, 0.0, NEG).to(dtype).expand(N, T)
    for u in range(U):
        if u == 0:
            b = seed
        else:
            b = torch.where(
                ((u - 1) < yn) & valid_t, carry + emit_lp[:, :, u - 1], NEG
            )
        carry = _solve(_shift_right(blank_lp[:, :, u], 1, 0.0), b)
        alphas.append(carry)
    return torch.stack(alphas, dim=2), betas


def alpha_beta(blank_lp, emit_lp, xn, yn, compute_alpha: bool = True):
    """Alphas and betas of the gathered lattice, (N, T, U) fp32 each.

    Returns (alphas, betas); alphas is None when ``compute_alpha=False`` (the
    beta-only inference sweep).  blank_lp, emit_lp: fp32 planes, or the two
    channels of one contiguous (N, T, U, 2) fp32 lattice, read in place.
    xn, yn: (N,) int32 on the lattice's device.  A CUDA lattice runs the
    kernel; a CPU lattice runs `alpha_beta_plain`.
    """
    if blank_lp.device.type == "cpu":
        return alpha_beta_plain(blank_lp, emit_lp, xn, yn, compute_alpha)
    _check(blank_lp, emit_lp, xn, yn)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"unsupported device {blank_lp.device}")
    stride = _check_inputs(blank_lp, emit_lp, xn, yn)
    N, T, U = blank_lp.shape
    plan = lattice_plan(T)
    lib = _lib()
    betas = torch.empty((N, T, U), dtype=torch.float32, device=blank_lp.device)
    alphas = torch.empty_like(betas) if compute_alpha else None
    stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
    with torch.cuda.device(blank_lp.device):
        code = lib.rnnt_lattice(
            blank_lp.data_ptr(), emit_lp.data_ptr(), stride, xn.data_ptr(),
            yn.data_ptr(), alphas.data_ptr() if compute_alpha else None,
            betas.data_ptr(), N, T, U, int(compute_alpha), stream,
            plan.frames, plan.warps,
        )
    _build.check(lib, "rnnt_lattice_error_string", code, "rnnt_lattice")
    LAUNCHES["lattice_fused" if compute_alpha else "lattice_beta_only"] += 1
    return alphas, betas


def _check_inputs(blank_lp, emit_lp, xn, yn):
    """The card's dtypes and layouts; returns the log-probs' element
    stride."""
    for name, x, dtype in (("blank_lp", blank_lp, torch.float32),
                           ("emit_lp", emit_lp, torch.float32),
                           ("xn", xn, torch.int32), ("yn", yn, torch.int32)):
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    for name, x in (("xn", xn), ("yn", yn)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stride = _build.elem_stride(blank_lp, "blank_lp")
    if _build.elem_stride(emit_lp, "emit_lp") != stride:
        raise ValueError("blank_lp and emit_lp must have one element stride")
    return stride


def _check_epilogue(blank_lp, alphas, betas, g_blank, g_emit):
    shape = tuple(blank_lp.shape)
    for name, x in (("alphas", alphas), ("betas", betas), ("g_blank", g_blank),
                    ("g_emit", g_emit)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got"
                             f" {tuple(x.shape)}")
        if x.device != blank_lp.device:
            raise ValueError(f"{name} is on {x.device}, blank_lp on"
                             f" {blank_lp.device}")
    if g_emit.dtype != g_blank.dtype or g_blank.dtype not in _OUT_DTYPES:
        raise ValueError(f"g_blank and g_emit must share one float dtype, got"
                         f" {g_blank.dtype} and {g_emit.dtype}")


def epilogue_plain(blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda,
                   g_blank, g_emit):
    """The plain version of `epilogue`: `postprocess.costs_and_grads`'s
    torch code, its gradients copied (rounded once, to nearest even) into
    ``g_blank`` and ``g_emit``.  Returns (costs (N,) fp32, the canary's
    mask (N,) bool)."""
    _check(blank_lp, emit_lp, xn, yn)
    _check_epilogue(blank_lp, alphas, betas, g_blank, g_emit)
    costs, gb, ge, bad = costs_grads_mask(
        blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda)
    g_blank.copy_(gb)
    g_emit.copy_(ge)
    return costs, bad


def epilogue(blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda,
             g_blank, g_emit):
    """The epilogue after the fused sweep, in one launch: writes the blank
    and emit gradients into ``g_blank`` and ``g_emit`` and returns (costs
    (N,) fp32, the canary's mask (N,) bool), as `costs_and_grads` computes
    them.

    blank_lp, emit_lp: fp32 planes or the two channels of one (N, T, U, 2)
    fp32 lattice; alphas, betas: the sweep's (N, T, U) fp32; g_blank,
    g_emit: (N, T, U) planes or the two channels of one (N, T, U, 2)
    tensor, in float32, float64, float16 or bfloat16.  On a CPU tensor it
    runs `epilogue_plain`; on a CUDA tensor it launches the kernel or
    raises.  The warning of ``WARP_RNNT_DEBUG`` is the caller's.
    """
    if _build.on_cpu(blank_lp):
        return epilogue_plain(blank_lp, emit_lp, alphas, betas, xn, yn,
                              fastemit_lambda, g_blank, g_emit)
    _check(blank_lp, emit_lp, xn, yn)
    _check_epilogue(blank_lp, alphas, betas, g_blank, g_emit)
    in_stride = _check_inputs(blank_lp, emit_lp, xn, yn)
    for name, x in (("alphas", alphas), ("betas", betas)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    out_stride = _build.elem_stride(g_blank, "g_blank")
    if _build.elem_stride(g_emit, "g_emit") != out_stride:
        raise ValueError("g_blank and g_emit must have one element stride")
    N, T, U = blank_lp.shape
    costs = torch.empty(N, dtype=torch.float32, device=blank_lp.device)
    bad = torch.empty(N, dtype=torch.bool, device=blank_lp.device)
    lib = _lib()
    stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
    with torch.cuda.device(blank_lp.device):
        code = lib.rnnt_lattice_epilogue(
            blank_lp.data_ptr(), emit_lp.data_ptr(), in_stride,
            alphas.data_ptr(), betas.data_ptr(), xn.data_ptr(), yn.data_ptr(),
            costs.data_ptr(), bad.data_ptr(), g_blank.data_ptr(),
            g_emit.data_ptr(), out_stride, _OUT_DTYPES[g_blank.dtype], N, T,
            U, -(1.0 + fastemit_lambda), stream,
        )
    _build.check(lib, "rnnt_lattice_error_string", code,
                 "rnnt_lattice_epilogue")
    LAUNCHES["lattice_epilogue"] += 1
    return costs, bad


def kernel_attrs(T: int, U: int):
    """The plan at (T, U) and what the kernel takes there: registers a
    thread, spill (local memory) bytes a thread, static shared memory bytes,
    the staged tile's columns, dynamic shared memory bytes, threads a
    block."""
    plan = lattice_plan(T)
    lib = _lib()
    vals = (ctypes.c_int * 5)()
    code = lib.rnnt_lattice_attrs(plan.frames, plan.warps, U, vals)
    _build.check(lib, "rnnt_lattice_error_string", code, "rnnt_lattice_attrs")
    return {**plan._asdict(), "registers": vals[0], "spill_bytes": vals[1],
            "static_smem": vals[2], "tile_cols": 1 << vals[3],
            "dynamic_smem": vals[4], "threads": 32 * plan.warps}


def lae_ns(n_lo: int = 2_000, n_hi: int = 202_000) -> float:
    """ns of one dependent logaddexp a = LSE(a + m, b), the lattice's chain
    step, on one thread of the current CUDA device: a probe kernel (not a
    kernel of any path) at two chain lengths, the difference over the extra
    steps, best of three."""
    io = torch.tensor([0.0, -0.5, -1.0], device="cuda")
    lib = _lib()

    def run_ms(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        code = lib.rnnt_lae_probe(io.data_ptr(), n,
                                  torch.cuda.current_stream().cuda_stream)
        end.record()
        _build.check(lib, "rnnt_lattice_error_string", code, "rnnt_lae_probe")
        end.synchronize()
        return start.elapsed_time(end)

    run_ms(n_lo)
    return min((run_ms(n_hi) - run_ms(n_lo)) / (n_hi - n_lo) * 1e6
               for _ in range(3))


def _fp32(x):
    """x as the lattice reads it: an fp32 plane or channel as it is,
    anything else cast to a contiguous fp32 plane."""
    if x.dtype == torch.float32 and _build.elem_stride(x) is not None:
        return x
    return x.float().contiguous()


def forward_backward(blank_lp, emit_lp, xn, yn, fastemit_lambda=0.0,
                     grads=None):
    """Kernel-backed equivalent of `scan_impl.forward_backward`: (costs,
    g_blank, g_emit, alphas, betas), the sweep then `epilogue`.

    blank_lp and emit_lp are read in place where they are fp32 planes or
    the channels of one (N, T, U, 2) fp32 lattice.  ``grads``, if given, is
    the (g_blank, g_emit) pair the epilogue writes (say the channels of an
    (N, T, U, 2) gradient in another dtype); by default two fp32 planes.
    """
    blank_lp, emit_lp = _fp32(blank_lp), _fp32(emit_lp)
    alphas, betas = alpha_beta(blank_lp, emit_lp, xn, yn, compute_alpha=True)
    if grads is None:
        grads = (torch.empty_like(alphas), torch.empty_like(alphas))
    costs, bad = epilogue(blank_lp, emit_lp, alphas, betas, xn, yn,
                          fastemit_lambda, *grads)
    warn_mismatch(bad, blank_lp, alphas, betas, xn, yn)
    return (costs, *grads, alphas, betas)


def forward_backward_gathered(xs_gathered, xn, yn, fastemit_lambda=0.0,
                              dtype=None):
    """The main path's sweep and epilogue on the gathered (N, T, U, 2)
    lattice: (costs, grads (N, T, U, 2) in ``dtype`` (default the
    lattice's), alphas, betas).  An fp32 lattice is read in place; any
    other is cast once, whole, to fp32.  The epilogue writes the
    interleaved gradient itself."""
    lat = xs_gathered.float().contiguous()
    grads = torch.empty(lat.shape, dtype=dtype or xs_gathered.dtype,
                        device=lat.device)
    costs, _, _, alphas, betas = forward_backward(
        lat[..., 0], lat[..., 1], xn, yn, fastemit_lambda,
        (grads[..., 0], grads[..., 1]))
    return costs, grads, alphas, betas


def costs_only(blank_lp, emit_lp, xn, yn):
    """Beta-only inference sweep: costs = -beta[:, 0, 0]."""
    _, betas = alpha_beta(_fp32(blank_lp), _fp32(emit_lp), xn, yn,
                          compute_alpha=False)
    return -betas[:, 0, 0]
