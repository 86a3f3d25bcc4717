"""Fused joint projection + RNN-T loss (counterpart of
`warp_rnnt_tpu/ops/fused_joint.py`).

From the projected joint halves

    a = f @ A + b_pre   (N, T, H)     c = g @ C   (N, U, H)

every lattice cell has the logits ``z = tanh(a_t + c_u) @ W_out + b_out``
(bf16 operands, fp32 sums), and the loss reads only three numbers of each
row: the blank logit, the label logit and logsumexp(z).  `joint_lattice_fwd`
computes those three (N, T, U) tensors and `joint_lattice_bwd` the gradients
of (a, c, W, b) from the lattice cotangents, both without the (N, T, U, V)
logits ever existing, in either direction.

On a CUDA tensor they launch the kernels of `csrc/fused_joint.cu` (which
replace the Pallas `_fwd_kernel` and `_bwd_kernel`; the backward is two
kernels, `d_a`/`d_c` and `d_W`/`d_b`), or raise.  On a CPU tensor they run
the plain torch versions below, which form the full logits.  There is no
fallback between the two.

What the JAX module has and this one does not:
  * ``interpret`` (run the Pallas kernel in the interpreter) has no torch
    meaning: the device of the tensors picks the kernel or the plain code.
  * `fused_joint_supported`, `_select_bv`, `_vmem_need`, `_tiles` and
    `_pad_vocab` answer whether one V block fits the TPU's VMEM, and pad the
    vocabulary to a whole number of blocks.  Hopper does not ask that: the
    CUDA kernels walk V in chunks of 64 columns with a running (max, sum)
    logsumexp at any V, and mask the last chunk's tail, so there is one
    route.  The same kernels therefore also replace the V-blocked Pallas
    kernels `_fwd_kernel_vb`, `_bwd_dadc_kernel_vb` and
    `_bwd_dwdb_kernel_vb`: the CPU tests hold the plain versions against
    them (JAX forced to 128-column blocks), and `chip_smoke.py` holds the
    kernels against the plain versions at V=64000 and V=50257.

What bounds the kernels and what their design does about it is noted at the
top of `csrc/fused_joint.cu`.
"""

from __future__ import annotations

import ctypes

import torch

from warp_rnnt_tpu_torch.functional.core import _costs_only, _forward_backward
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.ops import _build

# Launches per kernel, counted where the kernel is launched and nowhere else.
LAUNCHES = {"fused_joint_fwd": 0, "fused_joint_bwd_dadc": 0,
            "fused_joint_bwd_dwdb": 0}

MAX_H = 512  # the backward kernels keep d_h / d_W tiles in registers


def _lib():
    lib = _build.load("fused_joint")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fj_forward.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.fj_backward_dadc.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.fj_backward_dwdb.argtypes = [p] * 10 + [i] * 7 + [p]
        for fn in (lib.fj_forward, lib.fj_backward_dadc, lib.fj_backward_dwdb,
                   lib.fj_t_tiles, lib.fj_u_chunks):
            fn.restype = i
        lib.fj_t_tiles.argtypes = [i, i]
        lib.fj_u_chunks.argtypes = [i]
        lib.fj_error_string.argtypes = [i]
        lib.fj_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _shapes(a, c, w, b, labels_ext, xn):
    """Check shapes and devices; returns (N, T, U, H, V)."""
    if a.dim() != 3 or c.dim() != 3:
        raise ValueError(
            f"a must be (N, T, H) and c (N, U, H), got {tuple(a.shape)},"
            f" {tuple(c.shape)}"
        )
    N, T, H = a.shape
    U = c.shape[1]
    if c.shape[0] != N or c.shape[2] != H:
        raise ValueError(f"c {tuple(c.shape)} does not match a {tuple(a.shape)}")
    if w.dim() != 2 or w.shape[0] != H:
        raise ValueError(f"w must be ({H}, V), got {tuple(w.shape)}")
    V = w.shape[1]
    if tuple(b.shape) != (V,):
        raise ValueError(f"b must be ({V},), got {tuple(b.shape)}")
    if tuple(labels_ext.shape) != (N, U):
        raise ValueError(
            f"labels_ext must be ({N}, {U}), got {tuple(labels_ext.shape)}"
        )
    if tuple(xn.shape) != (N,):
        raise ValueError(f"xn must be ({N},), got {tuple(xn.shape)}")
    for name, x in (("c", c), ("w", w), ("b", b), ("labels_ext", labels_ext),
                    ("xn", xn)):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    return N, T, U, H, V


def _logits(a, c, w, b):
    """Plain joint logits: h fp32 (N, T, U, H), bf16-rounded h and W as fp32,
    and z = h_bf16 @ W_bf16 + b with fp32 sums."""
    h = torch.tanh(a.float()[:, :, None, :] + c.float()[:, None, :, :])
    hb = h.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    return h, hb, wb, torch.matmul(hb, wb) + b.float()


def _live(xn, T):
    """(N, T, 1) bool: frames inside the lengths."""
    return (torch.arange(T, device=xn.device)[None, :] < xn[:, None])[..., None]


def joint_lattice_fwd_plain(a, c, w, b, labels_ext, xn, yn, blank: int):
    """Plain torch version of the forward kernel: (blank_logit, emit_logit,
    logZ), each (N, T, U) fp32, zero at frames t >= xn."""
    N, T, U, H, V = _shapes(a, c, w, b, labels_ext, xn)
    _, _, _, z = _logits(a, c, w, b)
    idx = labels_ext.long()[:, None, :, None].expand(N, T, U, 1)
    live = _live(xn, T)
    outs = (z[..., blank], torch.gather(z, 3, idx)[..., 0], torch.logsumexp(z, -1))
    return tuple(torch.where(live, o, 0.0) for o in outs)


def _dlogits(z, labels_ext, xn, logz, db, de, blank):
    """dz = db*[v==blank] + de*[v==lab] - softmax*(db+de), zero at frames
    t >= xn (both terms are multiplied in, so lab == blank adds)."""
    N, T, U, V = z.shape
    live = _live(xn, T)
    db = torch.where(live, db.float(), 0.0)
    de = torch.where(live, de.float(), 0.0)
    v = torch.arange(V, device=z.device)
    sm = torch.exp(z - logz.float()[..., None])
    lab = labels_ext.long()[:, None, :, None]
    dz = (db[..., None] * (v == blank) + de[..., None] * (v == lab)
          - sm * (db + de)[..., None])
    return torch.where(live[..., None], dz, 0.0)


def bwd_dadc_plain(a, c, w, b, labels_ext, xn, yn, logz, db, de, blank: int):
    """Plain torch version of the d_a / d_c kernel: d_h = dz_bf16 @ W_bf16^T,
    dpre = d_h * (1 - h^2) with fp32 h, summed over u and over t."""
    _shapes(a, c, w, b, labels_ext, xn)
    h, _, wb, z = _logits(a, c, w, b)
    dz = _dlogits(z, labels_ext, xn, logz, db, de, blank)
    dpre = torch.matmul(dz.to(torch.bfloat16).float(), wb.t()) * (1.0 - h * h)
    return dpre.sum(2), dpre.sum(1)


def bwd_dwdb_plain(a, c, w, b, labels_ext, xn, yn, logz, db, de, blank: int):
    """Plain torch version of the d_W / d_b kernel: d_W = h_bf16^T @ dz_bf16,
    d_b = the sum of the fp32 dz."""
    _, _, _, H, V = _shapes(a, c, w, b, labels_ext, xn)
    _, hb, _, z = _logits(a, c, w, b)
    dz = _dlogits(z, labels_ext, xn, logz, db, de, blank)
    d_w = torch.matmul(hb.reshape(-1, H).t(),
                       dz.to(torch.bfloat16).float().reshape(-1, V))
    return d_w, dz.sum((0, 1, 2))


def joint_lattice_bwd_plain(a, c, w, b, labels_ext, xn, yn, logz, db, de,
                            blank: int):
    """Plain torch version of the backward kernels: (d_a, d_c, d_w, d_b),
    fp32, following `_bwd_kernel`'s arithmetic."""
    args = (a, c, w, b, labels_ext, xn, yn, logz, db, de, blank)
    return bwd_dadc_plain(*args) + bwd_dwdb_plain(*args)


def _chunked(w16, V):
    """(H, V) bf16 -> (ceil(V/64), H, 64), zero columns past V: each 64-column
    chunk of W one contiguous block, as the kernels load it."""
    H = w16.shape[0]
    chunks = -(-V // 64)
    w16 = torch.nn.functional.pad(w16, (0, chunks * 64 - V))
    return w16.view(H, chunks, 64).transpose(0, 1).contiguous()


def _kernel_inputs(a, c, w, b, labels_ext, xn, blank):
    """Cast and check the kernels' operands: a, c, b fp32, w bf16 in
    64-column chunks, labels_ext and xn int32, all contiguous on one CUDA
    device."""
    N, T, U, H, V = _shapes(a, c, w, b, labels_ext, xn)
    if not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")
    if H % 16 or not 16 <= H <= MAX_H:
        raise ValueError(
            f"joint width H={H} not supported by the CUDA kernels: it must be"
            f" a multiple of 16 in [16, {MAX_H}]"
        )
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if N > 65535 or min(T, U, V) < 1:
        raise ValueError(f"unsupported lattice (N, T, U, V) = {(N, T, U, V)}")
    ops = (a.float().contiguous(), c.float().contiguous(),
           _chunked(w.to(torch.bfloat16), V), b.float().contiguous())
    for name, x in (("labels_ext", labels_ext), ("xn", xn)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ops, (N, T, U, H, V)


def _lattice_operand(x, name, shape):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return x.float().contiguous()


def joint_lattice_fwd(a, c, w, b, labels_ext, xn, yn, blank: int):
    """(a, c, W, b) -> (blank_logit, emit_logit, logZ), each (N, T, U) fp32.

    a (N, T, H), c (N, U, H), w (H, V), b (V,); labels_ext (N, U) int32
    (label of row u, the blank on the last row); xn (N,) int32.  Frames
    t >= xn come back as zeros (the loss core masks them).  A CUDA tensor
    runs the kernel, a CPU tensor `joint_lattice_fwd_plain`.
    """
    if a.device.type == "cpu":
        return joint_lattice_fwd_plain(a, c, w, b, labels_ext, xn, yn, blank)
    (a, c, w, b), (N, T, U, H, V) = _kernel_inputs(a, c, w, b, labels_ext, xn,
                                                    blank)
    lib = _lib()
    out = [torch.empty((N, T, U), dtype=torch.float32, device=a.device)
           for _ in range(3)]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        code = lib.fj_forward(
            a.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
            labels_ext.data_ptr(), xn.data_ptr(), *(o.data_ptr() for o in out),
            N, T, U, H, V, blank, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_forward")
    LAUNCHES["fused_joint_fwd"] += 1
    return tuple(out)


def _bwd_dadc(ops, labels_ext, xn, lat, dims, blank):
    """The d_a / d_c kernel: returns (d_a, d_c, h16), h16 the (N*T*U, H)
    bf16 joint activations that the d_W / d_b kernel reads."""
    a, c, w, b = ops
    logz, db, de = lat
    N, T, U, H, V = dims
    lib = _lib()
    dev = a.device
    da_part = torch.empty((N, T, lib.fj_u_chunks(U), H), dtype=torch.float32,
                          device=dev)
    dc_part = torch.empty((N, lib.fj_t_tiles(T, U), U, H), dtype=torch.float32,
                          device=dev)
    h16 = torch.empty((N * T * U, H), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.fj_backward_dadc(
            a.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
            labels_ext.data_ptr(), xn.data_ptr(), logz.data_ptr(),
            db.data_ptr(), de.data_ptr(), da_part.data_ptr(),
            dc_part.data_ptr(), h16.data_ptr(), N, T, U, H, V, blank, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_backward_dadc")
    LAUNCHES["fused_joint_bwd_dadc"] += 1
    # partials summed in a fixed order: deterministic
    return da_part.sum(2), dc_part.sum(1), h16


def _row_groups(device, V, rows):
    """Row groups of the d_W / d_b kernel (one block per V chunk and group,
    one block per SM): the count, up to about three waves of blocks and one
    group per 64-row tile, whose last wave is fullest; the fewest on a tie."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = -(-V // 64)
    most = max(1, min(-(-rows // 64), -(-3 * sms // chunks)))

    def fill(groups):
        blocks = chunks * groups
        return blocks / (-(-blocks // sms) * sms)

    return max(range(1, most + 1), key=lambda g: (fill(g), -g))


def _bwd_dwdb(h16, ops, labels_ext, xn, lat, dims, blank):
    """The d_W / d_b kernel: returns (d_w, d_b)."""
    _, _, w, b = ops
    logz, db, de = lat
    N, T, U, H, V = dims
    lib = _lib()
    dev = w.device
    groups = _row_groups(dev, V, N * T * U)
    dw_part = torch.empty((groups, H, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((groups, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.fj_backward_dwdb(
            h16.data_ptr(), w.data_ptr(), b.data_ptr(), labels_ext.data_ptr(),
            xn.data_ptr(), logz.data_ptr(), db.data_ptr(), de.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), N, T, U, H, V, blank,
            groups, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_backward_dwdb")
    LAUNCHES["fused_joint_bwd_dwdb"] += 1
    return dw_part.sum(0), db_part.sum(0)


def _bwd_operands(a, c, w, b, labels_ext, xn, logz, db, de, blank):
    ops, dims = _kernel_inputs(a, c, w, b, labels_ext, xn, blank)
    N, T, U, _, _ = dims
    lat = tuple(_lattice_operand(x, name, (N, T, U))
                for x, name in ((logz, "logz"), (db, "db"), (de, "de")))
    return ops, lat, dims


def joint_lattice_bwd(a, c, w, b, labels_ext, xn, yn, logz, db, de,
                      blank: int):
    """Backward of the fused joint lattice: (d_a, d_c, d_w, d_b), fp32.

    logz is the forward's; db, de (N, T, U) are the cotangents of the blank
    and label log-probs (blank_logit - logZ, emit_logit - logZ).  A CUDA
    tensor runs the two backward kernels, a CPU tensor
    `joint_lattice_bwd_plain`.
    """
    if a.device.type == "cpu":
        return joint_lattice_bwd_plain(a, c, w, b, labels_ext, xn, yn, logz,
                                       db, de, blank)
    ops, lat, dims = _bwd_operands(a, c, w, b, labels_ext, xn, logz, db, de,
                                   blank)
    d_a, d_c, h16 = _bwd_dadc(ops, labels_ext, xn, lat, dims, blank)
    d_w, d_b = _bwd_dwdb(h16, ops, labels_ext, xn, lat, dims, blank)
    return d_a, d_c, d_w, d_b


class _FusedJointCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, c, w, b, labels_ext, xn, yn, blank, fastemit_lambda,
                impl):
        bl, el, lz = joint_lattice_fwd(a, c, w, b, labels_ext, xn, yn, blank)
        costs, g_blank, g_emit, _, _ = _forward_backward(
            bl - lz, el - lz, xn, yn, fastemit_lambda, impl
        )
        ctx.save_for_backward(a, c, w, b, labels_ext, xn, yn, lz, g_blank,
                              g_emit)
        ctx.blank = blank
        return costs

    @staticmethod
    def backward(ctx, ct):
        a, c, w, b, labels_ext, xn, yn, lz, g_blank, g_emit = ctx.saved_tensors
        ctb = ct.float()[:, None, None]
        d_a, d_c, d_w, d_b = joint_lattice_bwd(
            a, c, w, b, labels_ext, xn, yn, lz, ctb * g_blank, ctb * g_emit,
            ctx.blank,
        )
        return (d_a.to(a.dtype), d_c.to(c.dtype), d_w.to(w.dtype),
                d_b.to(b.dtype), None, None, None, None, None, None)


def fused_joint_core(a, c, w, b, labels, xn, yn, blank=0, fastemit_lambda=0.0,
                     impl="auto"):
    """Per-sample RNN-T costs (N,) straight from the projected joint halves.

    a (N, T, H), c (N, U, H); w (H, V), b (V,); labels (N, U-1) int32.
    Differentiable w.r.t. (a, c, w, b); the (N, T, U, V) logits tensor is
    never formed on the card, forward or backward.  ``impl`` picks the
    lattice backend (`functional.core`).  When no gradient is needed the
    beta-only sweep gives the costs, chosen before `Function.apply`.
    """
    lab = _labels_ext(labels, blank)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (a, c, w, b))):
        bl, el, lz = joint_lattice_fwd(a, c, w, b, lab, xn, yn, blank)
        return _costs_only(bl - lz, el - lz, xn, yn, impl)
    return _FusedJointCore.apply(a, c, w, b, lab, xn, yn, blank,
                                 fastemit_lambda, impl)


def _project(f, g, params, mode="add", compute_dtype=torch.bfloat16):
    """The joint's pre-projections: a = f @ A + b_pre (N, T, H) and
    c = g @ C (N, U, H), operands rounded to ``compute_dtype`` and summed in
    fp32.  "add": A = C = w_pre; "concat": A and C are w_pre's row blocks
    for f and g.  (`functional.joint_loss`'s compact layout uses it too:
    it is the JAX package's `_pre_projections`.)"""
    def rnd(x):
        return x.to(compute_dtype).float()

    w_pre, b_pre = params["w_pre"], params["b_pre"]
    F = f.shape[-1]
    if mode == "add":
        wa = wc = rnd(w_pre)
    elif mode == "concat":
        wa, wc = rnd(w_pre[:F]), rnd(w_pre[F:])
    else:
        raise ValueError(f"unknown joint mode: {mode!r}")
    return (torch.matmul(rnd(f), wa) + b_pre.float(), torch.matmul(rnd(g), wc))


def rnnt_loss_fused_joint(
    f, g, params, labels, frames_lengths, labels_lengths,
    average_frames: bool = False, reduction=None, blank: int = 0,
    fastemit_lambda: float = 0.0, impl: str = "auto", mode: str = "add",
):
    """End-to-end fused joint + RNN-T loss.

    f (N, T, F) encoder outputs, g (N, U, F') predictor outputs, and the
    joint parameters ``params = dict(w_pre, b_pre, w_out, b_out)`` of the
    Tanh-MLP joint (`warp_rnnt_tpu_torch.models.joint.Joint`, in the Flax
    layout: kernels are (in, out)): combine -> dense(H) -> tanh -> dense(V).
    "add" mode: w_pre (F, H) applied to both halves; "concat": w_pre
    (F+F', H) split into row blocks per half.

    The pre-projections are plain torch matmuls of bf16-rounded operands in
    fp32 (the JAX package's ``preferred_element_type=f32``); the
    V-projection, logsumexp and blank/label pick run in the fused kernels,
    so the (N, T, U, V) logits tensor never exists on the card.  The JAX
    function's ``interpret`` argument has no torch meaning and is dropped.
    """
    if reduction not in (None, "none", "mean", "sum"):
        raise ValueError(
            f"Unknown reduction method: {reduction}, expected to be one of"
            " ['mean', 'sum', 'none']"
        )
    a, c = _project(f, g, params, mode)
    xn = frames_lengths.to(torch.int32)
    yn = labels_lengths.to(torch.int32)
    costs = fused_joint_core(a, c, params["w_out"], params["b_out"], labels,
                             xn, yn, blank, fastemit_lambda, impl)
    if average_frames:
        costs = costs / xn.to(costs.dtype)
    if reduction in (None, "none"):
        return costs
    return costs.sum() if reduction == "sum" else costs.mean()
