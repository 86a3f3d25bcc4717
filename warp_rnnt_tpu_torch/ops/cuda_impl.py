"""CUDA lattice kernels (`csrc/lattice.cu`) and their plain torch twin
(counterpart of `warp_rnnt_tpu/ops/pallas_impl.py`).

`alpha_beta` replaces the Pallas `_fused_kernel` (``compute_alpha=True``) and
`_beta_only_kernel` (``compute_alpha=False``).  On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs `alpha_beta_plain`, a torch
version of the same doubling scan with the same -1e30 sentinel.  Invalid
cells hold values near the sentinel in both; only valid cells (t < xn,
u <= yn) are meaningful.

What bounds the kernel and what its design does about that is noted at the
top of `csrc/lattice.cu`.
"""

from __future__ import annotations

import ctypes

import torch

from warp_rnnt_tpu_torch.functional.postprocess import costs_and_grads
from warp_rnnt_tpu_torch.ops import _build

NEG = -1.0e30

# Launches per kernel, counted where the kernel is launched and nowhere else.
LAUNCHES = {"lattice_fused": 0, "lattice_beta_only": 0}


def _lib():
    lib = _build.load("lattice")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lattice.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.rnnt_lattice.restype = i
        lib.rnnt_lattice_error_string.argtypes = [i]
        lib.rnnt_lattice_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


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
    """logaddexp on finite sentinel values (never sees true -inf)."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _scan(m, b):
    """Inclusive solve of a[j] = LSE(a[j-1] + m[j], b[j]) along the last axis
    (`pallas_impl._scan_fwd`; `_scan_bwd` is this on a reversed axis)."""
    k = 1
    while k < m.shape[-1]:
        ms = _shift_right(m, k, 0.0)
        bs = _shift_right(b, k, NEG)
        b = _lae(bs + m, b)
        m = ms + m
        k *= 2
    return b


def alpha_beta_plain(blank_lp, emit_lp, xn, yn, compute_alpha: bool = True):
    """Plain torch twin of the lattice kernels: (alphas or None, betas)."""
    _check(blank_lp, emit_lp, xn, yn)
    blank_lp = blank_lp.float()
    emit_lp = emit_lp.float()
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
            _scan(torch.flip(blank_col, (1,)), torch.flip(b, (1,))), (1,)
        )
        betas[u] = carry
    betas = torch.stack(betas, dim=2)
    if not compute_alpha:
        return None, betas

    alphas = []
    seed = torch.where(t_iota == 0, 0.0, NEG).float().expand(N, T)
    for u in range(U):
        if u == 0:
            b = seed
        else:
            b = torch.where(
                ((u - 1) < yn) & valid_t, carry + emit_lp[:, :, u - 1], NEG
            )
        carry = _scan(_shift_right(blank_lp[:, :, u], 1, 0.0), b)
        alphas.append(carry)
    return torch.stack(alphas, dim=2), betas


def alpha_beta(blank_lp, emit_lp, xn, yn, compute_alpha: bool = True):
    """Alphas and betas of the gathered lattice, (N, T, U) fp32 each.

    Returns (alphas, betas); alphas is None when ``compute_alpha=False`` (the
    beta-only inference sweep).  xn, yn: (N,) int32 on the lattice's device.
    A CUDA lattice runs the kernel; a CPU lattice runs `alpha_beta_plain`.
    """
    if blank_lp.device.type == "cpu":
        return alpha_beta_plain(blank_lp, emit_lp, xn, yn, compute_alpha)
    _check(blank_lp, emit_lp, xn, yn)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"unsupported device {blank_lp.device}")
    for name, x, dtype in (("blank_lp", blank_lp, torch.float32),
                           ("emit_lp", emit_lp, torch.float32),
                           ("xn", xn, torch.int32), ("yn", yn, torch.int32)):
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N, T, U = blank_lp.shape
    lib = _lib()
    betas = torch.empty_like(blank_lp)
    alphas = torch.empty_like(blank_lp) if compute_alpha else None
    stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
    with torch.cuda.device(blank_lp.device):
        code = lib.rnnt_lattice(
            blank_lp.data_ptr(), emit_lp.data_ptr(), xn.data_ptr(),
            yn.data_ptr(), alphas.data_ptr() if compute_alpha else None,
            betas.data_ptr(), N, T, U, int(compute_alpha), stream,
        )
    _build.check(lib, "rnnt_lattice_error_string", code, "rnnt_lattice")
    LAUNCHES["lattice_fused" if compute_alpha else "lattice_beta_only"] += 1
    return alphas, betas


def forward_backward(blank_lp, emit_lp, xn, yn, fastemit_lambda=0.0):
    """Kernel-backed equivalent of `scan_impl.forward_backward`."""
    blank_lp = blank_lp.float().contiguous()
    emit_lp = emit_lp.float().contiguous()
    alphas, betas = alpha_beta(blank_lp, emit_lp, xn, yn, compute_alpha=True)
    costs, g_blank, g_emit = costs_and_grads(
        blank_lp, emit_lp, alphas, betas, xn, yn, fastemit_lambda
    )
    return costs, g_blank, g_emit, alphas, betas


def costs_only(blank_lp, emit_lp, xn, yn):
    """Beta-only inference sweep: costs = -beta[:, 0, 0]."""
    _, betas = alpha_beta(blank_lp.float().contiguous(),
                          emit_lp.float().contiguous(), xn, yn,
                          compute_alpha=False)
    return -betas[:, 0, 0]
