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

The kernels take any joint width H >= 1 and any N.  All three pad H up to
S slices of at most 256 columns, each a multiple of 64 (`bwd_plan`): zero
columns of a and c, zero rows of W (tanh(0) = 0 adds nothing); the
backward cuts d_a, d_c and d_W back to H (`pad_h`, `unpad_h`).  They read
W and h as the shared-memory images `wgmma` takes: the W image
(`_w_image`), laid out once a loss+grad and kept from the forward for the
backward, and past one slice the h image of `h_image`, which the h kernel
(`_hidden_image`) writes before the forward and again before the backward.
A grid of few tiles splits V over blocks (`_v_parts`); the forward's
parts then leave per-row partials that `merge_v_parts` combines.  The cost
of each route against the R x H x V bound is noted at the top of
`csrc/fused_joint.cu`, with what bounds the kernels and what their design
does about it.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from warp_rnnt_tpu_torch.functional.core import _costs_only, _forward_backward
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.ops import _build

# Launches per kernel, counted where the kernel is launched and nowhere else.
LAUNCHES = {"fused_joint_hidden": 0, "fused_joint_fwd": 0,
            "fused_joint_bwd_dadc": 0, "fused_joint_bwd_dwdb": 0}

# fj_hidden_image's argument block: a, c, xn, h16, N, T, U, H, S, stream
_HIDDEN_ARGS = struct.Struct("<10q")

_MAX_SLICE = 256  # widest H slice of the kernels (a warpgroup's registers)
_SLICE_STEP = 64  # the slices are multiples of one wgmma N tile
_ROWS = 64  # lattice rows per tile (one wgmma M tile)
_VC = 64  # vocabulary columns per W image block


def _lib():
    lib = _build.load("fused_joint")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fj_hidden_image.argtypes = [ctypes.c_char_p]
        lib.fj_forward.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.fj_backward_dadc.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.fj_backward_dwdb.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.fj_kernel_attrs.argtypes = [i, i, i, p]
        for fn in (lib.fj_hidden_image, lib.fj_forward, lib.fj_backward_dadc,
                   lib.fj_backward_dwdb, lib.fj_kernel_attrs):
            fn.restype = i
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


def bwd_plan(H: int):
    """(Hp, S): the kernels' width for a joint of width H >= 1, S
    slices of Hp / S columns, each a multiple of 64 (one wgmma N tile) and
    at most 256 (a warpgroup's d_h or d_W, 64 x 256 fp32, is 128 registers
    a thread); S = ceil(H / 256) and the slices as even as 64 allows
    (H=200 -> (256, 1), 512 -> (512, 2), 640 -> (768, 3), 2048 ->
    (2048, 8))."""
    S = -(-H // _MAX_SLICE)
    return S * (-(-H // (_SLICE_STEP * S)) * _SLICE_STEP), S


def pad_h(a, c, w, Hp: int):
    """a (N, T, H), c (N, U, H), w (H, V) with zero columns of a and c and
    zero rows of w up to width Hp: the same logits, since tanh(0) = 0 and a
    zero row of W adds nothing.  A w of None stays None."""
    extra = Hp - a.shape[-1]
    if extra == 0:
        return a, c, w
    pad = torch.nn.functional.pad
    return (pad(a, (0, extra)), pad(c, (0, extra)),
            None if w is None else pad(w, (0, 0, 0, extra)))


def unpad_h(d_a, d_c, d_w, H: int):
    """The gradients of `pad_h`'s operands cut back to width H (the padded
    columns and rows hold zeros)."""
    return d_a[..., :H], d_c[..., :H], d_w[:H]


def _w_chunks(V):
    """64-column W image blocks of a slice: ceil(V/64) rounded up to even,
    so the d_W / d_b kernel's 128-column chunks are whole."""
    chunks = -(-V // _VC)
    return chunks + chunks % 2


def _w_image(w, b, V, Hp, S):
    """The kernels' W image, (S, `_w_chunks`(V), HS*64 + 128) bf16: block
    (s, chunk) holds bf16 W[s*HS:(s+1)*HS, 64*chunk:64*chunk+64] as 8 x 8
    core matrices of 16-byte rows, each row 8 columns v of one k (element
    (k, v) at (k/8)*64 + (v/8)*HS*8 + (k%8)*8 + v%8, the address rule of
    the kernels' descriptors `desc_w` and `desc_wt`), zero past V and in
    the rows past w's own up to Hp, and then the chunk's 64 biases as fp32
    (-inf past V, so the kernels' exp and dz are 0 there).  Each block is
    one contiguous copy into shared memory."""
    HS = Hp // S
    nc = _w_chunks(V)
    w16 = torch.nn.functional.pad(w.to(torch.bfloat16),
                                  (0, nc * _VC - V, 0, Hp - w.shape[0]))
    img = (w16.view(S, HS // 8, 8, nc, 8, 8)   # s, kb, kr, chunk, vb, vr
           .permute(0, 3, 4, 1, 2, 5)          # s, chunk, vb, kb, kr, vr
           .reshape(S, nc, HS * _VC))
    bias = torch.nn.functional.pad(b.float(), (0, nc * _VC - V),
                                   value=float("-inf"))
    bias = bias.view(nc, _VC).view(torch.bfloat16).expand(S, nc, 2 * _VC)
    return torch.cat((img, bias), 2).contiguous()


def _geom(T: int, U: int):
    """(ut, bt, nuc, ntb) of the kernels' 64-row tiles: ut = min(U, 64) rows
    of bt = 64 // ut frames, nuc U chunks of a frame, ntb frame blocks of a
    sample (`make_geom` in `csrc/fused_joint.cu`)."""
    ut = min(U, _ROWS)
    bt = _ROWS // ut
    return ut, bt, -(-U // ut), -(-T // bt)


def n_tiles(N: int, T: int, U: int) -> int:
    """Tiles of the lattice, numbered sample-major: (n, frame block, U
    chunk)."""
    _, _, nuc, ntb = _geom(T, U)
    return N * ntb * nuc


def tile_cells(N: int, T: int, U: int):
    """(tiles, 64) long: the flat cell (n*T + t)*U + u of each tile row, -1
    for rows past the lattice (`tile_row`)."""
    ut, bt, nuc, ntb = _geom(T, U)
    tile = torch.arange(n_tiles(N, T, U))[:, None]
    i = torch.arange(_ROWS)[None, :]
    n, rest = tile // (ntb * nuc), tile % (ntb * nuc)
    tb, uc = rest // nuc, rest % nuc
    tt, uu = i // ut, i % ut
    t, u = tb * bt + tt, uc * ut + uu
    valid = (tt < bt) & (t < T) & (u < U)
    return torch.where(valid, (n * T + t) * U + u, -1)


def hidden_plain(a, c, xn):
    """bf16(tanh(a[n, t] + c[n, u])) as rows (N*T*U, H), zero rows at
    frames t >= xn: the rows `hidden_image_plain` lays out."""
    N, T, H = a.shape
    U = c.shape[1]
    h = torch.tanh(a.float()[:, :, None, :] + c.float()[:, None, :, :])
    h = torch.where(_live(xn, T)[..., None], h, 0.0)
    return h.to(torch.bfloat16).reshape(N * T * U, H)


def hidden_image_plain(a, c, xn, S):
    """Plain torch version of the h kernel: `h_image` of `hidden_plain`'s
    rows."""
    N, T, _ = a.shape
    return h_image(hidden_plain(a, c, xn), N, T, c.shape[1], S)


def h_image(rows, N, T, U, S):
    """The kernels' h image of bf16 rows (N*T*U, H): (tiles, S, 64 * HS)
    bf16, block (tile, s) holding rows[cell, s*HS + k] of the tile's cells
    at (row/8)*64 + (k/8)*512 + (row%8)*8 + k%8, zeros for tile rows past
    the lattice."""
    HS = rows.shape[1] // S
    cells = tile_cells(N, T, U).to(rows.device)
    h = torch.where((cells >= 0)[..., None], rows[cells.clamp(min=0)], 0.0)
    h = h.to(torch.bfloat16).view(-1, 8, 8, S, HS // 8, 8)  # rb, rr, s, kb, kr
    return h.permute(0, 3, 4, 1, 2, 5).reshape(-1, S, _ROWS * HS).contiguous()


def _kernel_inputs(a, c, w, b, labels_ext, xn, blank):
    """Cast, pad and check the kernels' operands: a, c, b fp32, a and c
    padded to `bwd_plan`'s width, labels_ext and xn int32, all contiguous
    on one CUDA device; w as given (`_w_image` casts and pads it).
    Returns (operands (a, c, w, b), dims (N, T, U, Hp, V, S), H)."""
    N, T, U, H, V = _shapes(a, c, w, b, labels_ext, xn)
    if not 0 <= blank < V:
        raise ValueError(f"blank={blank} outside [0, {V})")
    if min(N, T, U, H, V) < 1:
        raise ValueError(f"empty joint (N, T, U, H, V) = {(N, T, U, H, V)}")
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    for name, x in (("labels_ext", labels_ext), ("xn", xn)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Hp, S = bwd_plan(H)
    a, c, _ = pad_h(a.float(), c.float(), None, Hp)
    ops = (a.contiguous(), c.contiguous(), w, b.float().contiguous())
    return ops, (N, T, U, Hp, V, S), H


def _hidden_image(a, c, xn, dims):
    """The h kernel (S > 1): the h image of every tile and slice
    (`hidden_image_plain`), zeros for rows that are not live.  One ctypes
    argument (a packed block); the device context is entered only for a
    tensor off the current device."""
    N, T, U, Hp, _, S = dims
    lib = _lib()
    h16 = torch.empty((n_tiles(N, T, U), S, _ROWS * (Hp // S)),
                      dtype=torch.bfloat16, device=a.device)
    dev = a.get_device()
    args = _HIDDEN_ARGS.pack(a.data_ptr(), c.data_ptr(), xn.data_ptr(),
                             h16.data_ptr(), N, T, U, Hp, S,
                             _build.raw_stream(dev))
    code = _build.on_device(dev, lib.fj_hidden_image, args)
    if code:
        _build.check(lib, "fj_error_string", code, "fj_hidden_image")
    LAUNCHES["fused_joint_hidden"] += 1
    return h16


def _lattice_operand(x, name, shape):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return x.float().contiguous()


def merge_v_parts(part, live):
    """The forward's V parts merged: part (4, parts, N, T, U) holds each
    part's per-row max, sum of exp(z - max), blank logit and label logit
    (0 where the part does not hold the column); returns (blank_logit,
    emit_logit, logZ), zero where ``live`` (N, T, 1) is false.  logZ is the
    logsumexp of the parts' (max, sum), taken over the parts in order; a
    part whose columns are all padding has max -inf and sum 0 and adds
    nothing.  Each pick sits in exactly one part, so the picks are sums."""
    m, s = part[0], part[1]
    ref = torch.nan_to_num(m.amax(0), neginf=0.0)
    logz = ref + torch.log((s * torch.exp(m - ref)).sum(0))
    picks = part[2:].sum(1)
    return tuple(torch.where(live, torch.cat((picks, logz[None])), 0.0))


def _fwd_launch(ops, labels_ext, xn, dims, blank, h16=None):
    """The forward kernel on the kernels' operands (a, c, W image) at the
    padded width, h16 the h image when S > 1: (blank_logit, emit_logit,
    logZ).  A grid of few tiles splits V (`_v_parts`; the forward's grid
    has no slice dimension); its parts are merged by `merge_v_parts`."""
    a, c, wimg = ops
    N, T, U, Hp, V, S = dims
    dev = a.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = _v_parts(sms, n_tiles(N, T, U), 1, V)
    out = torch.empty(((3,) if parts == 1 else (4, parts)) + (N, T, U),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.fj_forward(
            a.data_ptr(), c.data_ptr(), wimg.data_ptr(), labels_ext.data_ptr(),
            xn.data_ptr(), None if h16 is None else h16.data_ptr(),
            out.data_ptr(), N, T, U, Hp, V, blank, S, parts, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_forward")
    LAUNCHES["fused_joint_fwd"] += 1
    if parts > 1:
        return merge_v_parts(out, _live(xn, T))
    return tuple(out)


def _forward(a, c, w, b, labels_ext, xn, blank):
    """The forward on CUDA operands: ((blank_logit, emit_logit, logZ), W
    image).  Past one slice the h kernel writes the h image first."""
    (a, c, w, b), dims, _ = _kernel_inputs(a, c, w, b, labels_ext, xn, blank)
    N, T, U, Hp, V, S = dims
    wimg = _w_image(w, b, V, Hp, S)
    h16 = _hidden_image(a, c, xn, dims) if S > 1 else None
    return _fwd_launch((a, c, wimg), labels_ext, xn, dims, blank, h16), wimg


def joint_lattice_fwd(a, c, w, b, labels_ext, xn, yn, blank: int):
    """(a, c, W, b) -> (blank_logit, emit_logit, logZ), each (N, T, U) fp32.

    a (N, T, H), c (N, U, H), w (H, V), b (V,); labels_ext (N, U) int32
    (label of row u, the blank on the last row); xn (N,) int32.  Frames
    t >= xn come back as zeros (the loss core masks them).  A CUDA tensor
    runs the kernel, a CPU tensor `joint_lattice_fwd_plain`.
    """
    if a.device.type == "cpu":
        return joint_lattice_fwd_plain(a, c, w, b, labels_ext, xn, yn, blank)
    return _forward(a, c, w, b, labels_ext, xn, blank)[0]


def _fullest(sms: int, unit: int, most: int) -> int:
    """The count k in [1, most] whose k * unit blocks (one per SM) leave the
    last wave fullest; the fewest on a tie."""
    def fill(k):
        blocks = unit * k
        return blocks / (-(-blocks // sms) * sms)

    return max(range(1, max(1, most) + 1), key=lambda k: (fill(k), -k))


def _row_groups(sms: int, V: int, tiles: int, S: int = 1):
    """Row groups of the d_W / d_b kernel (one block per 128-column chunk,
    group and slice): up to about three waves of blocks and one group per
    tile (each group's d_W partial is H x V fp32)."""
    unit = -(-V // (2 * _VC)) * S
    return _fullest(sms, unit, min(tiles, -(-3 * sms // unit), 65535))


def _v_parts(sms: int, tiles: int, S: int, V: int) -> int:
    """V parts of the d_a / d_c kernel (one block per tile pair, slice and
    part) and of the forward (its grid has no slice dimension: S = 1): up
    to about three waves of blocks, no part empty.  A grid of few tiles
    (small N at a large V) splits V to fill the card."""
    unit = -(-tiles // 2) * S
    chunks = -(-V // _VC)
    parts = _fullest(sms, unit, min(chunks, -(-3 * sms // unit), 65535))
    return -(-chunks // -(-chunks // parts))


def _bwd_dadc(ops, labels_ext, xn, lat, dims, blank, h16=None):
    """The d_a / d_c kernel: returns (d_a, d_c, h16) at the padded width,
    h16 the backward's h image that the d_W / d_b kernel reads: written by
    this kernel at S = 1, by the h kernel before it at S > 1 (or given)."""
    a, c, wimg = ops
    logz, db, de = lat
    N, T, U, Hp, V, S = dims
    lib = _lib()
    dev = a.device
    if h16 is None:
        h16 = (_hidden_image(a, c, xn, dims) if S > 1 else
               torch.empty((n_tiles(N, T, U), S, _ROWS * (Hp // S)),
                           dtype=torch.bfloat16, device=dev))
    _, _, nuc, ntb = _geom(T, U)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = _v_parts(sms, n_tiles(N, T, U), S, V)
    da_part = torch.empty((N, T, nuc, parts, Hp), dtype=torch.float32,
                          device=dev)
    dc_part = torch.empty((N, ntb, parts, U, Hp), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.fj_backward_dadc(
            a.data_ptr(), c.data_ptr(), wimg.data_ptr(), labels_ext.data_ptr(),
            xn.data_ptr(), logz.data_ptr(), db.data_ptr(), de.data_ptr(),
            da_part.data_ptr(), dc_part.data_ptr(), h16.data_ptr(), N, T, U,
            Hp, V, blank, S, parts, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_backward_dadc")
    LAUNCHES["fused_joint_bwd_dadc"] += 1
    # partials summed in a fixed order: deterministic
    return da_part.sum((2, 3)), dc_part.sum((1, 2)), h16


def _bwd_dwdb(h16, ops, labels_ext, xn, lat, dims, blank):
    """The d_W / d_b kernel: returns (d_w, d_b), d_w at the padded width."""
    wimg = ops[2]
    logz, db, de = lat
    N, T, U, Hp, V, S = dims
    lib = _lib()
    dev = wimg.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = _row_groups(sms, V, n_tiles(N, T, U), S)
    dw_part = torch.empty((groups, Hp, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((groups, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.fj_backward_dwdb(
            h16.data_ptr(), wimg.data_ptr(), labels_ext.data_ptr(),
            xn.data_ptr(), logz.data_ptr(), db.data_ptr(), de.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), N, T, U, Hp, V, blank,
            groups, S, stream,
        )
    _build.check(lib, "fj_error_string", code, "fj_backward_dwdb")
    LAUNCHES["fused_joint_bwd_dwdb"] += 1
    return dw_part.sum(0), db_part.sum(0)


def kernel_attrs(H: int):
    """{kernel: {registers, spill_bytes, static_smem, dynamic_smem, stages}}
    of the forward and the two backward kernels at `bwd_plan(H)`, as the
    compiler built them (registers at entry: the consumers raise theirs to
    232)."""
    Hp, S = bwd_plan(H)
    lib = _lib()
    out = {}
    for idx, name in ((2, "fused_joint_fwd"), (0, "fused_joint_bwd_dadc"),
                      (1, "fused_joint_bwd_dwdb")):
        vals = (ctypes.c_int * 5)()
        code = lib.fj_kernel_attrs(idx, Hp // S, S, vals)
        _build.check(lib, "fj_error_string", code, "fj_kernel_attrs")
        out[name] = dict(zip(("registers", "spill_bytes", "static_smem",
                              "dynamic_smem", "stages"), vals))
    return out


def _bwd_operands(a, c, w, b, labels_ext, xn, logz, db, de, blank,
                  wimg=None):
    """The backward kernels' operands: (a, c, W image) at `bwd_plan`'s
    width (the image laid out here unless the forward's is given), the
    three lattices, dims (N, T, U, Hp, V, S) and H."""
    (a, c, w, b), dims, H = _kernel_inputs(a, c, w, b, labels_ext, xn, blank)
    N, T, U, Hp, V, S = dims
    lat = tuple(_lattice_operand(x, name, (N, T, U))
                for x, name in ((logz, "logz"), (db, "db"), (de, "de")))
    if wimg is None:
        wimg = _w_image(w, b, V, Hp, S)
    return (a, c, wimg), lat, dims, H


def joint_lattice_bwd(a, c, w, b, labels_ext, xn, yn, logz, db, de,
                      blank: int):
    """Backward of the fused joint lattice: (d_a, d_c, d_w, d_b), fp32.

    logz is the forward's; db, de (N, T, U) are the cotangents of the blank
    and label log-probs (blank_logit - logZ, emit_logit - logZ).  A CUDA
    tensor runs the two backward kernels, a CPU tensor
    `joint_lattice_bwd_plain`.
    """
    return _lattice_bwd(a, c, w, b, labels_ext, xn, yn, logz, db, de, blank)


def _lattice_bwd(a, c, w, b, labels_ext, xn, yn, logz, db, de, blank,
                 wimg=None):
    """`joint_lattice_bwd`, reading the forward's W image when given."""
    if a.device.type == "cpu":
        return joint_lattice_bwd_plain(a, c, w, b, labels_ext, xn, yn, logz,
                                       db, de, blank)
    ops, lat, dims, H = _bwd_operands(a, c, w, b, labels_ext, xn, logz, db, de,
                                      blank, wimg)
    d_a, d_c, h16 = _bwd_dadc(ops, labels_ext, xn, lat, dims, blank)
    d_w, d_b = _bwd_dwdb(h16, ops, labels_ext, xn, lat, dims, blank)
    return (*unpad_h(d_a, d_c, d_w, H), d_b)


class _FusedJointCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, c, w, b, labels_ext, xn, yn, blank, fastemit_lambda,
                impl):
        if a.device.type == "cpu":
            wimg = None
            bl, el, lz = joint_lattice_fwd_plain(a, c, w, b, labels_ext, xn,
                                                 yn, blank)
        else:  # the W image is laid out once and kept for the backward
            (bl, el, lz), wimg = _forward(a, c, w, b, labels_ext, xn, blank)
        costs, g_blank, g_emit, _, _ = _forward_backward(
            bl - lz, el - lz, xn, yn, fastemit_lambda, impl
        )
        ctx.save_for_backward(a, c, w, b, labels_ext, xn, yn, lz, g_blank,
                              g_emit, wimg)
        ctx.blank = blank
        return costs

    @staticmethod
    def backward(ctx, ct):
        (a, c, w, b, labels_ext, xn, yn, lz, g_blank, g_emit,
         wimg) = ctx.saved_tensors
        ctb = ct.float()[:, None, None]
        d_a, d_c, d_w, d_b = _lattice_bwd(
            a, c, w, b, labels_ext, xn, yn, lz, ctb * g_blank, ctb * g_emit,
            ctx.blank, wimg,
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
