"""The decode step's kernels (`csrc/decode_step.cu`) and their plain torch
versions: the joint and the predictor's GRU cell of one step of the
greedy or beam-search loop, over every hypothesis of the batch.

No TPU kernel stands behind them: in the JAX package the step is the body
of ``lax.while_loop`` (`warp_rnnt_tpu/models/decoding.py:119`,
`warp_rnnt_tpu/models/beam_search.py:298`; beam's selection, gathers,
hash and merge :207-294), which XLA fuses, its loop
invariants hoisted.  The port lifts those invariants itself
(`models.decoding.decode_consts`, once a drain) and hands them to these
functions: the joint's weights and biases in its compute dtype, the
weights in Flax's (in, out) layout, contiguous, and the GRU's recurrent
bias (0, 0, bias_hn).

  * `decode_joint(enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out, mode,
    blank, k)`: for each row (hypothesis) of ``pred_out`` (rows, F'), the
    frame of its sample (row r is sample r // (rows // N)) at
    ``clamp(t - p0, 0, C - 1)`` of enc (N, C, F), the joint's log-probs of
    that cell, and then greedy's first maximal label (``k`` None: best
    (rows,) int32) or beam's blank log-prob and top ``k`` labels (the
    blank at `NEG`, as `top_k_small` selects them): (lp_blank (rows,),
    top_lp (rows, k), top_ids (rows, k) int32).  Three launches.
  * `decode_beam_select(t, scores, tokens, u, nexp, waiting, hcode,
    lp_blank, top_lp, top_ids, frame_bound, max_symbols)`: the rest of
    the beam-search step around the joint and the GRU: the candidates'
    top-k over B (K + 1) a sample, the beams' gathers, the token write,
    the prefix hash, the merge of duplicates and the frame advance; the
    new state and, for the GRU, each new beam's emit, token and source
    row.  One launch, exact (the same fp32 adds, the rest comparisons
    and integers).
  * `decode_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
    src=None)`: torch's GRU cell on each row's token embedding (a token
    < 0 is the zero <sos> embedding), written where ``emit`` holds; a row
    that does not emit keeps its input rows bit for bit.  With ``src``,
    row r reads ``h[src[r]]`` and ``out[src[r]]`` (beam's parents).  One
    launch.
  * `decode_gru_greedy(best, t, u, emitted_here, frame_bound, tokens, h,
    out, embed, w_ih, w_hh, b_ih, b_hh, blank, max_symbols)`: the same
    launch with greedy's masked update folded in: the emit mask from the
    frame pointers, budgets and ``best``, and the new t, u, emitted_here
    and token buffer.

A CPU tensor runs the plain version beside each wrapper (the step's torch
code as the decoders ran it before these kernels, on the lifted
invariants); a CUDA tensor launches the kernels, and a failed build or
launch raises: there is no fallback.  The wrappers check shapes only and
read nothing back from the device, so they capture into the decode loop's
CUDA graphs.  The kernels ignore torch's TF32 and reduced-precision matmul
flags (which key `utils.device_loop`'s graph cache all the same): the
bf16 products run on the tensor cores with fp32 sums, the fp32 ones in
fp32 on the CUDA cores.  `PLAIN` holds the plain versions under the
wrappers' names, the ``ops`` a decoder takes for the card checks' plain
decode (`benchmarks/decode_step_cases.py`).
"""

from __future__ import annotations

import ctypes
import struct
import types

import torch
from torch.nn import functional as F

from warp_rnnt_tpu_torch.ops import _build

# Kernels launched, counted where they are launched and nowhere else
# (decode_joint launches three a call; a CUDA graph's replays launch
# without Python, so a graphed loop counts its warm-up and capture only).
LAUNCHES = {"decode_joint": 0, "decode_gru": 0, "decode_beam_select": 0}

NEG = -1.0e30  # the blank's score among the beam's label candidates
MAX_K = 64  # top-k labels a row, and beams a sample (csrc kMaxK)
_HASH_MUL = 1000003
_HASH_MASK = 0xFFFFFFFF

# The argument blocks of decode_joint, decode_gru and decode_beam_select
# (csrc/decode_step.cu lists their entries).
_JOINT_ARGS = struct.Struct("<27q")
_GRU_ARGS = struct.Struct("<28q")
_SELECT_ARGS = struct.Struct("<27q")
_LIB: list = []  # the loaded library and its three typed entries


def _entries():
    if not _LIB:
        lib = _build.load("decode_step")
        entries = (lib.decode_joint, lib.decode_gru, lib.decode_beam_select)
        for fn in entries:
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
        lib.decode_step_error_string.argtypes = [ctypes.c_int]
        lib.decode_step_error_string.restype = ctypes.c_char_p
        _LIB[:] = [lib, *entries]
    return _LIB


def frame_at(enc, t, p0):
    """enc (N, C, H) holding stream positions [p0, p0 + C) -> the frame at
    each sample's position t (N,), clipped into the chunk: (N, H)."""
    N, C, H = enc.shape
    idx = (t - p0).clamp(0, C - 1).long()
    return enc.gather(1, idx[:, None, None].expand(N, 1, H))[:, 0]


def top_k_small(x, k):
    """Exact top-k over the trailing axis for small k, as k argmax rounds.

    Selection runs on a copy whose -inf entries are clamped to the dtype's
    finite minimum, and each picked index is masked to -inf: so the
    indices stay distinct even when fewer than k entries are finite
    (exhausted slices fall back to ascending first-unpicked indices).
    Values are gathered from the original x, so -inf entries report -inf.
    Ties go to the lowest index.
    """
    vals, ids = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    sel = x.clamp(min=torch.finfo(x.dtype).min)
    for _ in range(k):
        i = sel.argmax(dim=-1)
        vals.append(x.gather(-1, i[..., None])[..., 0])
        ids.append(i)
        sel = torch.where(iota == i[..., None], -torch.inf, sel)
    return torch.stack(vals, -1), torch.stack(ids, -1).to(torch.int32)


def _fail(what):
    raise ValueError(what)


def _joint_shapes(enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out, mode,
                  blank, k, logp_out):
    """Check decode_joint's arguments; returns (N, C, F, F', rows, H, V)."""
    if mode not in ("add", "concat"):
        _fail(f"unknown joint mode: {mode!r}")
    if enc.dim() != 3 or enc.dtype != torch.float32 or enc.shape[1] < 1:
        _fail(f"enc must be (N, C >= 1, F) float32, got {tuple(enc.shape)}"
              f" {enc.dtype}")
    N, C, Fe = enc.shape
    if (pred_out.dim() != 2 or pred_out.dtype != torch.float32 or N < 1
            or pred_out.shape[0] % N):
        _fail(f"pred_out must be (rows, F') float32 with rows a multiple of"
              f" N={N}, got {tuple(pred_out.shape)} {pred_out.dtype}")
    rows, Fg = pred_out.shape
    if mode == "add" and Fe != Fg:
        _fail(f"add joint: enc width {Fe} != pred_out width {Fg}")
    cd = w_pre.dtype
    if cd not in (torch.bfloat16, torch.float32):
        _fail(f"the joint's weights must be bfloat16 or float32, got {cd}")
    K = Fe + Fg if mode == "concat" else Fe
    if w_pre.dim() != 2 or w_pre.shape[0] != K:
        _fail(f"w_pre must be ({K}, H), got {tuple(w_pre.shape)}")
    H = w_pre.shape[1]
    if w_out.dim() != 2 or w_out.shape[0] != H:
        _fail(f"w_out must be ({H}, V), got {tuple(w_out.shape)}")
    V = w_out.shape[1]
    for name, x, shape in (("b_pre", b_pre, (H,)), ("w_out", w_out, (H, V)),
                           ("b_out", b_out, (V,))):
        if tuple(x.shape) != shape or x.dtype != cd:
            _fail(f"{name} must be {shape} {cd}, got {tuple(x.shape)}"
                  f" {x.dtype}")
    if tuple(t.shape) != (N,) or t.dtype != torch.int32:
        _fail(f"t must be ({N},) int32, got {tuple(t.shape)} {t.dtype}")
    if p0.numel() != 1 or p0.dtype != torch.int32:
        _fail(f"p0 must be one int32, got {tuple(p0.shape)} {p0.dtype}")
    if not 0 <= blank < V:
        _fail(f"blank={blank} outside [0, {V})")
    if k is not None and not 1 <= k <= min(MAX_K, V - 1):
        _fail(f"k={k} outside [1, {min(MAX_K, V - 1)}]")
    if logp_out is not None and (tuple(logp_out.shape) != (rows, V)
                                 or logp_out.dtype != torch.float32):
        _fail(f"logp_out must be ({rows}, {V}) float32")
    return N, C, Fe, Fg, rows, H, V


def _ready(tensors, device):
    """The CUDA-only checks: every tensor on the step's device, contiguous."""
    for name, x in tensors:
        if x.device != device:
            _fail(f"{name} is on {x.device}, the step on {device}")
        if not x.is_contiguous():
            _fail(f"{name} must be contiguous")


def decode_joint_plain(enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out,
                       mode="add", blank=0, k=None, logp_out=None):
    """Plain torch version of `decode_joint`: the joint of `models.joint`
    on the rows' cells, then `epilogue_plain`."""
    # models imports this module; the joint is read when the step runs
    from warp_rnnt_tpu_torch.models.joint import joint_logits

    N, _, Fe = enc.shape
    rows = pred_out.shape[0]
    f = frame_at(enc, t, p0)
    if rows != N:
        f = f[:, None, :].expand(N, rows // N, Fe).reshape(rows, Fe)
    params = {"w_pre": w_pre, "b_pre": b_pre, "w_out": w_out, "b_out": b_out}
    logp = joint_logits(f[:, None, :], pred_out[:, None, :], params, mode,
                        w_pre.dtype)[:, 0, 0, :]
    if logp_out is not None:
        logp_out.copy_(logp)
    return epilogue_plain(logp, blank, k)


def epilogue_plain(logp, blank=0, k=None):
    """The joint's epilogue on its log-probs (rows, V), as the decoders
    read them: greedy's first maximal label (``k`` None; (rows,) int32),
    or beam's (the blank's log-prob (rows,), the top ``k`` labels' values
    and ids (rows, k)) by `top_k_small` with the blank at `NEG`."""
    if k is None:
        return logp.argmax(dim=-1).to(torch.int32)
    lab = logp.clone()
    lab[:, blank] = NEG
    top_lp, top_ids = top_k_small(lab, k)
    return logp[:, blank], top_lp, top_ids


def decode_joint(enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out,
                 mode="add", blank=0, k=None, logp_out=None):
    """The joint of each row's cell and greedy's or beam's epilogue (see
    the module docstring); ``logp_out`` (rows, V) float32, when given,
    receives the rows' log-probs (for the card check).  A CUDA tensor
    launches the three kernels, a CPU tensor runs the plain version."""
    if _build.on_cpu(enc):
        return decode_joint_plain(enc, t, p0, pred_out, w_pre, b_pre, w_out,
                                  b_out, mode, blank, k, logp_out)
    N, C, Fe, Fg, rows, H, V = _joint_shapes(
        enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out, mode, blank, k,
        logp_out)
    dev = enc.device
    named = [("enc", enc), ("t", t), ("p0", p0), ("pred_out", pred_out),
             ("w_pre", w_pre), ("b_pre", b_pre), ("w_out", w_out),
             ("b_out", b_out)]
    if logp_out is not None:
        named.append(("logp_out", logp_out))
    _ready(named, dev)
    if -(-rows // 32) > 65535:
        _fail(f"{rows} rows exceed the kernels' grid")
    hid = torch.empty((rows, H), dtype=w_pre.dtype, device=dev)
    logits = torch.empty((rows, V), dtype=torch.float32, device=dev)
    if k is None:
        out = best = torch.empty((rows,), dtype=torch.int32, device=dev)
        beam = (0, 0, 0)
    else:
        best = None
        out = (torch.empty((rows,), dtype=torch.float32, device=dev),
               torch.empty((rows, k), dtype=torch.float32, device=dev),
               torch.empty((rows, k), dtype=torch.int32, device=dev))
        beam = tuple(x.data_ptr() for x in out)
    if rows == 0:
        return out
    lib = _LIB if _LIB else _entries()
    index = dev.index
    args = _JOINT_ARGS.pack(
        enc.data_ptr(), t.data_ptr(), p0.data_ptr(), pred_out.data_ptr(),
        w_pre.data_ptr(), b_pre.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), hid.data_ptr(), logits.data_ptr(),
        0 if logp_out is None else logp_out.data_ptr(),
        0 if best is None else best.data_ptr(), *beam, N, C, Fe, Fg, rows,
        H, V, int(mode == "concat"), int(w_pre.dtype == torch.bfloat16),
        blank, k or 0, _build.raw_stream(index))
    code = _build.on_device(index, lib[1], args)
    if code:
        _build.check(lib[0], "decode_step_error_string", code, "decode_joint")
    LAUNCHES["decode_joint"] += 3
    return out


def decode_gru_plain(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
                     src=None):
    """Plain torch version of `decode_gru`: the rows of ``src`` gathered
    (when given), `Predictor.step`'s embedding and ``torch.gru_cell``,
    then the decoders' ``torch.where`` on emit."""
    if src is not None:
        h, out = h.index_select(0, src.long()), out.index_select(0, src.long())
    token = token.long()
    emb = F.embedding(token.clamp(min=0), embed)
    emb = torch.where(token[:, None] < 0, emb.new_zeros(()), emb)
    new = torch.gru_cell(emb, h, w_ih, w_hh, b_ih, b_hh)
    return (torch.where(emit[:, None], new, h),
            torch.where(emit[:, None], new, out))


def decode_gru_greedy_plain(best, t, u, emitted_here, frame_bound, tokens,
                            h, out, embed, w_ih, w_hh, b_ih, b_hh, blank,
                            max_symbols):
    """Plain torch version of `decode_gru_greedy`: greedy's masked update
    (`models.decoding.greedy_drain`) around `decode_gru_plain`."""
    L = tokens.shape[1]
    l_iota = torch.arange(L, device=tokens.device)[None, :]
    active = t < frame_bound
    emit = (active & (best != blank) & (u < L)
            & (emitted_here < max_symbols))
    tokens = torch.where(emit[:, None] & (l_iota == u[:, None]),
                         best[:, None], tokens)
    h, out = decode_gru_plain(best, h, out, emit, embed, w_ih, w_hh, b_ih,
                              b_hh)
    u_new = torch.where(emit, u + 1, u)
    emitted_here = torch.where(emit, emitted_here + 1, 0)
    t = torch.where(active & ~emit, t + 1, t)
    return t, u_new, emitted_here, tokens, h, out


def _gru_check(token, h, out, embed, w_ih, w_hh, b_ih, b_hh):
    """Check decode_gru's shared arguments; returns (rows, H)."""
    if h.dim() != 2 or h.dtype != torch.float32 or h.shape[1] < 1:
        _fail(f"h must be (rows, H >= 1) float32, got {tuple(h.shape)}"
              f" {h.dtype}")
    rows, H = h.shape
    for name, x, shape in (("out", out, (rows, H)),
                           ("w_ih", w_ih, (3 * H, H)),
                           ("w_hh", w_hh, (3 * H, H)),
                           ("b_ih", b_ih, (3 * H,)), ("b_hh", b_hh, (3 * H,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            _fail(f"{name} must be {shape} float32, got {tuple(x.shape)}"
                  f" {x.dtype}")
    if embed.dim() != 2 or embed.shape[1] != H or embed.dtype != torch.float32:
        _fail(f"embed must be (vocab, {H}) float32, got {tuple(embed.shape)}")
    if tuple(token.shape) != (rows,) or token.dtype != torch.int32:
        _fail(f"token must be ({rows},) int32, got {tuple(token.shape)}"
              f" {token.dtype}")
    if -(-rows // 32) > 65535:
        _fail(f"{rows} rows exceed the kernel's grid")
    return rows, H


def _launch_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
                greedy=None, L=0, blank=0, max_symbols=0, src=None):
    """One decode_gru launch; ``greedy`` = (t, u, emitted_here,
    frame_bound, tokens) folds greedy's update in; ``src`` maps each row
    to the row of h and out it reads.  Returns (h', out') and, with
    ``greedy``, (t', u', emitted_here', tokens')."""
    rows, H = h.shape
    dev = h.device
    named = [("token", token), ("h", h), ("out", out), ("embed", embed),
             ("w_ih", w_ih), ("w_hh", w_hh), ("b_ih", b_ih), ("b_hh", b_hh)]
    if emit is not None:
        named.append(("emit", emit))
    if src is not None:
        named.append(("src", src))
    if greedy is not None:
        named += list(zip(("t", "u", "emitted_here", "frame_bound", "tokens"),
                          greedy))
    _ready(named, dev)
    h_out, out_out = torch.empty_like(h), torch.empty_like(out)
    ints = (0,) * 9
    fields = ()
    if greedy is not None:
        fields = tuple(torch.empty_like(x) for x in (*greedy[:3], greedy[4]))
        ints = (*(x.data_ptr() for x in greedy),
                *(x.data_ptr() for x in fields))
    if rows:
        lib = _LIB if _LIB else _entries()
        index = dev.index
        args = _GRU_ARGS.pack(
            token.data_ptr(), embed.data_ptr(), h.data_ptr(), out.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), 0 if emit is None else emit.data_ptr(),
            h_out.data_ptr(), out_out.data_ptr(), *ints, embed.shape[0],
            rows, H, L, blank, max_symbols, _build.raw_stream(index),
            0 if src is None else src.data_ptr())
        code = _build.on_device(index, lib[2], args)
        if code:
            _build.check(lib[0], "decode_step_error_string", code,
                         "decode_gru")
        LAUNCHES["decode_gru"] += 1
    return h_out, out_out, fields


def decode_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
               src=None):
    """h (rows, H), out (rows, H), token (rows,) int32, emit (rows,) bool,
    the GRU's fp32 parameters (embed (vocab, H); w_ih, w_hh (3H, H), gates
    r, z, n; b_ih, b_hh (3H,)), optionally src (rows,) int32 in [0, rows)
    -> (h', out'): row r's inputs are ``h[src[r]]`` and ``out[src[r]]``
    (row r without ``src``), the GRU cell where emit holds, those inputs
    elsewhere.  A CUDA tensor launches the kernel, a CPU tensor runs the
    plain version."""
    if _build.on_cpu(h):
        return decode_gru_plain(token, h, out, emit, embed, w_ih, w_hh, b_ih,
                                b_hh, src)
    rows, _ = _gru_check(token, h, out, embed, w_ih, w_hh, b_ih, b_hh)
    for name, x, dtype in (("emit", emit, torch.bool),
                           ("src", src, torch.int32)):
        if x is not None and (tuple(x.shape) != (rows,) or x.dtype != dtype):
            _fail(f"{name} must be ({rows},) {dtype}, got {tuple(x.shape)}"
                  f" {x.dtype}")
    return _launch_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih,
                       b_hh, src=src)[:2]


def decode_gru_greedy(best, t, u, emitted_here, frame_bound, tokens, h, out,
                      embed, w_ih, w_hh, b_ih, b_hh, blank, max_symbols):
    """Greedy's step after the joint: best (N,) int32 (the joint's label),
    the state's t, u, emitted_here (N,) int32, tokens (N, L) int32, h and
    out (N, H), frame_bound (N,) int32 -> (t', u', emitted_here',
    tokens', h', out'), as `models.decoding.greedy_drain` updates them
    (`decode_gru_greedy_plain`).  A CUDA tensor launches the kernel, a CPU
    tensor runs the plain version."""
    if _build.on_cpu(h):
        return decode_gru_greedy_plain(
            best, t, u, emitted_here, frame_bound, tokens, h, out, embed,
            w_ih, w_hh, b_ih, b_hh, blank, max_symbols)
    rows, _ = _gru_check(best, h, out, embed, w_ih, w_hh, b_ih, b_hh)
    for name, x in (("t", t), ("u", u), ("emitted_here", emitted_here),
                    ("frame_bound", frame_bound)):
        if tuple(x.shape) != (rows,) or x.dtype != torch.int32:
            _fail(f"{name} must be ({rows},) int32, got {tuple(x.shape)}"
                  f" {x.dtype}")
    if (tokens.dim() != 2 or tokens.shape[0] != rows
            or tokens.dtype != torch.int32):
        _fail(f"tokens must be ({rows}, L) int32, got {tuple(tokens.shape)}"
              f" {tokens.dtype}")
    h_new, out_new, (t, u, emitted_here, tokens) = _launch_gru(
        best, h, out, None, embed, w_ih, w_hh, b_ih, b_hh,
        (t, u, emitted_here, frame_bound, tokens), tokens.shape[1], blank,
        max_symbols)
    return t, u, emitted_here, tokens, h_new, out_new


def hash_step(hcode, tok):
    """The rolling prefix hash after appending ``tok``: JAX's uint32
    ``h * 1000003 + tok + 1`` with wrap-around, on int64 in [0, 2^32)
    (the product stays below 2^53)."""
    return (hcode * _HASH_MUL + (tok.long() + 1)) & _HASH_MASK


def gather_beams(x, parent):
    """x (N, B, ...) -> x[n, parent[n, b], ...]."""
    idx = parent.long().reshape(parent.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(parent.shape + x.shape[2:]))


def decode_beam_select_plain(t, scores, tokens, u, nexp, waiting, hcode,
                             lp_blank, top_lp, top_ids, frame_bound,
                             max_symbols):
    """Plain torch version of `decode_beam_select`: the beam-search
    step's torch code between the joint and the GRU, and after the GRU,
    as `models.beam_search.beam_drain` ran it."""
    N, B, L = tokens.shape
    K = top_lp.shape[1]
    dev = tokens.device
    lp_blank = lp_blank.reshape(N, B)
    top_lp, top_ids = top_lp.reshape(N, B, K), top_ids.reshape(N, B, K)
    l_iota = torch.arange(L, device=dev)[None, None, :]
    i_iota = torch.arange(B, device=dev)[None, :, None]
    j_iota = torch.arange(B, device=dev)[None, None, :]
    frame_on = (t < frame_bound)[:, None]  # (N, 1)

    # a beam may expand while its sample's frame is live, it has not
    # settled this frame, it has token budget and is under the cap
    alive = scores > 0.5 * NEG
    expandable = (frame_on & alive & ~waiting & (u < L)
                  & (nexp < max_symbols))

    # column 0: blank (active beams) / self (settled or off-frame)
    settle = torch.where(frame_on & ~waiting, scores + lp_blank, scores)
    # columns 1..K: the top-K labels
    lab_scores = torch.where(expandable[..., None],
                             scores[..., None] + top_lp, NEG)
    cand = torch.cat([settle[..., None], lab_scores], -1)

    new_scores, sel = top_k_small(cand.reshape(N, B * (K + 1)), B)
    parent = sel // (K + 1)  # (N, B)
    kind = sel % (K + 1)  # 0 = blank/self

    tokens = gather_beams(tokens, parent)
    u = gather_beams(u, parent)
    nexp = gather_beams(nexp, parent)
    hcode = gather_beams(hcode, parent)
    scores = new_scores
    emit = kind > 0

    new_tok = gather_beams(top_ids, parent).gather(
        2, (kind - 1).clamp(min=0).long()[..., None])[..., 0]  # (N, B)
    tokens = torch.where(emit[..., None] & (l_iota == u[..., None]),
                         new_tok[..., None], tokens)
    u = torch.where(emit, u + 1, u)
    nexp = torch.where(emit, nexp + 1, nexp)
    hcode = torch.where(emit, hash_step(hcode, new_tok), hcode)
    # blank/self settles the beam for this frame; emits stay active
    waiting = frame_on & ~emit

    # merge duplicate hypotheses: the same hash (the same prefix, but
    # for a 32-bit collision), length and within-frame state are one
    # hypothesis; the better-scored copy survives (ties: lower index)
    same = ((hcode[:, :, None] == hcode[:, None, :])
            & (u[:, :, None] == u[:, None, :])
            & (waiting[:, :, None] == waiting[:, None, :]))
    s_i = scores[:, :, None]
    s_j = scores[:, None, :]
    beats = (s_i > s_j) | ((s_i == s_j) & (i_iota < j_iota))
    killed = (same & beats & (i_iota != j_iota)).any(dim=1)
    scores = torch.where(killed, NEG, scores)

    # a sample whose live beams are all settled is done with this
    # frame: advance its pointer and re-arm every beam
    active = ~waiting & (scores > 0.5 * NEG)
    advance = (t < frame_bound) & ~active.any(dim=1)
    t = torch.where(advance, t + 1, t)
    waiting = waiting & ~advance[:, None]
    nexp = torch.where(advance[:, None], 0, nexp)
    src = (torch.arange(N, dtype=torch.int32, device=dev)[:, None] * B
           + parent)
    return (t, scores, tokens, u, nexp, waiting, hcode, emit.reshape(-1),
            new_tok.reshape(-1), src.reshape(-1))


def _select_check(t, scores, tokens, u, nexp, waiting, hcode, lp_blank,
                  top_lp, top_ids, frame_bound):
    """Check decode_beam_select's arguments; returns (N, B, L, K)."""
    if tokens.dim() != 3 or tokens.dtype != torch.int32:
        _fail(f"tokens must be (N, B, L) int32, got {tuple(tokens.shape)}"
              f" {tokens.dtype}")
    N, B, L = tokens.shape
    if not 1 <= B <= MAX_K:
        _fail(f"beam width {B} outside [1, {MAX_K}]")
    if top_lp.dim() != 2 or top_lp.shape[0] != N * B:
        _fail(f"top_lp must be ({N * B}, K), got {tuple(top_lp.shape)}")
    K = top_lp.shape[1]
    if not 1 <= K <= MAX_K:
        _fail(f"K={K} outside [1, {MAX_K}]")
    for name, x, shape, dtype in (
            ("t", t, (N,), torch.int32), ("scores", scores, (N, B),
                                          torch.float32),
            ("u", u, (N, B), torch.int32), ("nexp", nexp, (N, B), torch.int32),
            ("waiting", waiting, (N, B), torch.bool),
            ("hcode", hcode, (N, B), torch.int64),
            ("lp_blank", lp_blank, (N * B,), torch.float32),
            ("top_lp", top_lp, (N * B, K), torch.float32),
            ("top_ids", top_ids, (N * B, K), torch.int32),
            ("frame_bound", frame_bound, (N,), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            _fail(f"{name} must be {shape} {dtype}, got {tuple(x.shape)}"
                  f" {x.dtype}")
    return N, B, L, K


def decode_beam_select(t, scores, tokens, u, nexp, waiting, hcode, lp_blank,
                       top_lp, top_ids, frame_bound, max_symbols):
    """The beam-search step between the joint and the GRU: the state's t
    (N,) int32, scores (N, B) fp32, tokens (N, B, L) int32, u and nexp
    (N, B) int32, waiting (N, B) bool, hcode (N, B) int64;
    `decode_joint`'s beam outputs lp_blank (N B,), top_lp (N B, K) fp32,
    top_ids (N B, K) int32; frame_bound (N,) int32; the emission cap ->
    (t', scores', tokens', u', nexp', waiting', hcode', emit (N B,) bool,
    new_tok (N B,) int32, src (N B,) int32: row n B + b's parent row),
    as `decode_beam_select_plain`, bit for bit.  B and K at most
    `MAX_K`.  A CUDA tensor launches the kernel, a CPU tensor runs the
    plain version."""
    if _build.on_cpu(tokens):
        return decode_beam_select_plain(t, scores, tokens, u, nexp, waiting,
                                        hcode, lp_blank, top_lp, top_ids,
                                        frame_bound, max_symbols)
    ins = (t, scores, tokens, u, nexp, waiting, hcode, lp_blank, top_lp,
           top_ids, frame_bound)
    N, B, L, K = _select_check(*ins)
    dev = tokens.device
    _ready(zip(("t", "scores", "tokens", "u", "nexp", "waiting", "hcode",
                "lp_blank", "top_lp", "top_ids", "frame_bound"), ins), dev)
    outs = tuple(torch.empty_like(x) for x in ins[:7])
    rows = N * B
    outs += (torch.empty((rows,), dtype=torch.bool, device=dev),
             torch.empty((rows,), dtype=torch.int32, device=dev),
             torch.empty((rows,), dtype=torch.int32, device=dev))
    if N:
        lib = _LIB if _LIB else _entries()
        index = dev.index
        args = _SELECT_ARGS.pack(
            *(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs), N,
            B, K, L, max_symbols, _build.raw_stream(index))
        code = _build.on_device(index, lib[3], args)
        if code:
            _build.check(lib[0], "decode_step_error_string", code,
                         "decode_beam_select")
        LAUNCHES["decode_beam_select"] += 1
    return outs


# The plain versions under the wrappers' names: a decoder's ``ops`` for a
# plain decode on any device (the card checks' reference).
PLAIN = types.SimpleNamespace(
    __name__="plain", decode_joint=decode_joint_plain,
    decode_gru=decode_gru_plain, decode_gru_greedy=decode_gru_greedy_plain,
    decode_beam_select=decode_beam_select_plain)
