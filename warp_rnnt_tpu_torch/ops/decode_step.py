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

`decode_gru_greedy` (given ``last_tok`` and ``count``) and
`decode_beam_select` (given ``count``) also fold in the device loop's
mask and count (`utils.device_loop`, ``folded=True``): each computes
JAX's ``cond``, ``go = any(t < frame_bound)`` over the batch, from the
step's inputs, writes the new state where ``go`` holds and its inputs
through where it does not (beam: ``emit`` 0 and ``src`` the identity, so
that `decode_gru` copies every row), and ``count + go``.  Their plain
versions do what the loop did: the same ``cond``, ``torch.where`` and add
(`_fold`), bit for bit.

The launch plan of the dense and GRU kernels (`dense_plan`, `gru_plan`:
the blocks a thread-block cluster that split K, each block's K share,
the chunk and stages of its shared-memory ring, its dynamic shared
bytes, the GRU's rows a block and K groups) is computed here from the
shapes and passed in the argument blocks; the kernels refuse a plan
whose shared bytes they compute otherwise.

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

import contextlib
import ctypes
import functools
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
# (csrc/decode_step.cu lists their entries): the joint's and the GRU's
# fields, then their plans.
_JOINT_ARGS = struct.Struct("<37q")
# The loop's fold (last_tok and count in and out; count in and out) comes
# last, where `csrc/decode_step_baseline.cu`'s entries do not read.
_GRU_ARGS = struct.Struct("<39q")
_SELECT_ARGS = struct.Struct("<33q")

# The launch plans' limits (csrc/decode_step.cu): shared memory a block
# can use on Hopper, less what the kernels declare statically; blocks a
# cluster (the portable most); stages of a ring.
SMEM_MAX = 232448
STATIC_SMEM = 2048
CLUSTER_MAX = 8
RING_STAGES = 3
THREADS = 128  # a dense or GRU block
ROW_TILE, COL_TILE = 32, 16  # a dense block's rows and columns
GRU_UNITS = 32  # hidden units a GRU block
K_STEP = 16  # K shares and chunks are multiples of it (mma.sync's K)
DENSE_BLOCKS = 256  # a dense launch's blocks, at most (two an SM)
GRU_BLOCKS = 132  # a GRU launch's blocks, at most (one an SM)
GRU_SMEM = 112 * 1024  # a GRU block's dynamic shared bytes, at most (two an SM)
GRU_BOX = 32  # k a box of the GRU's weights; its shares and chunks are multiples
GRU_STAGES = 2  # a GRU ring's stages
SELECT_WARPS = 4  # samples (one warp each) a select block, at most
SELECT_SLOTS = (1, 2, 4)  # candidates a lane holds in registers
SELECT_SMEM = 96 * 1024  # a select block's dynamic shared bytes, at most

# The library the wrappers launch (`csrc/<name>.cu`; `using` switches it)
# and each loaded library's typed entries.
_SOURCE = ["decode_step"]
_LIBS: dict = {}


def _entries():
    name = _SOURCE[0]
    lib = _build.load(name)
    entries = {}
    for entry in ("decode_joint", "decode_gru", "decode_beam_select"):
        fn = getattr(lib, entry, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
        entries[entry] = fn
    lib.decode_step_error_string.argtypes = [ctypes.c_int]
    lib.decode_step_error_string.restype = ctypes.c_char_p
    _LIBS[name] = (lib, entries)
    return _LIBS[name]


@contextlib.contextmanager
def using(source):
    """Launch the kernels of ``csrc/<source>.cu`` inside the block (whose
    entries read the same argument blocks): the benchmarks' way to time
    another build of the step in turns with this one."""
    old = _SOURCE[0]
    _SOURCE[0] = source
    try:
        yield
    finally:
        _SOURCE[0] = old


def folds():
    """True where the current library's entries fold the device loop's
    mask and count in (`csrc/decode_step.cu`; not the first kernels of
    `csrc/decode_step_baseline.cu`, which `using` may switch to)."""
    return _SOURCE[0] == "decode_step"


def pdl_built():
    """True where `csrc/decode_step.cu` was built with programmatic
    dependent launch (its launches may start before the one before them
    ends, in a CUDA graph too)."""
    return bool(_build.load("decode_step").decode_step_pdl())


def _launch(entry, args, index, what):
    """Call ``entry`` of the current library on the packed ``args`` with
    CUDA device ``index`` current; raise on a CUDA error."""
    lib, entries = _LIBS.get(_SOURCE[0]) or _entries()
    code = _build.on_device(index, entries[entry], args)
    if code:
        _build.check(lib, "decode_step_error_string", code, what)


def _ceil(a, b):
    return -(-a // b)


def _cluster(tiles, blocks):
    """The largest power of two, at most `CLUSTER_MAX`, whose multiple of
    ``tiles`` is at most ``blocks`` (1 where none is)."""
    cluster = CLUSTER_MAX
    while cluster > 1 and cluster * tiles > blocks:
        cluster //= 2
    return cluster


def _k_split(K, cluster, step=K_STEP):
    """(cluster, K share): ``cluster`` (a power of two, at most
    `CLUSTER_MAX`) halved until every rank's share of K, a multiple of
    ``step``, holds some of K."""
    while True:
        share = _ceil(_ceil(K, cluster), step) * step
        if cluster == 1 or (cluster - 1) * share < K:
            return cluster, share
        cluster //= 2


def _ring(share, smem_of, budget=SMEM_MAX - STATIC_SMEM, step=K_STEP,
          stages=RING_STAGES):
    """(chunk, stages): the whole share at once where ``smem_of(chunk,
    stages)`` fits in ``budget`` (default: `SMEM_MAX` less `STATIC_SMEM`),
    else a ring of at most ``stages`` balanced chunks (multiples of
    ``step``), the largest that fit."""
    if smem_of(share, 1) <= budget:
        return share, 1
    chunk = step
    while smem_of(chunk + step, stages) <= budget:
        chunk += step
    if smem_of(chunk, stages) > budget:
        raise ValueError(f"no ring of {stages} stages fits a K share of"
                         f" {share}")
    n = _ceil(share, chunk)
    return _ceil(_ceil(share, n), step) * step, min(stages, n)


def dense_smem(elem, first, concat, chunk, stages):
    """Dynamic shared bytes of a dense block (csrc `dense_smem`): the
    weight stages; the hidden layer's fp32 input stages (one array concat,
    two add) and its T tile, else the T input stages; the fp32 partial
    sums; the warps' sums; 128 bytes to align the first to 128."""
    vec = 16 // elem
    raw = 4 * stages * (1 if concat else 2) * ROW_TILE * (chunk + 4) if first else 0
    a = (1 if first else stages) * ROW_TILE * (chunk + vec) * elem
    w = stages * chunk * COL_TILE * elem
    return raw + a + w + 4 * ROW_TILE * COL_TILE * (1 + THREADS // 32) + 128


@functools.lru_cache(maxsize=256)
def dense_plan(rows, K, cols, elem, first, concat=False):
    """The launch plan of one dense layer of `decode_joint` (``first``: the
    hidden layer on fp32 inputs, ``concat`` or add; else the logits) for
    ``rows`` x K inputs, ``cols`` outputs, weights of ``elem`` bytes:
    {cluster, k_share, chunk, stages, smem, grid, threads}.  Blocks of
    `ROW_TILE` x `COL_TILE`; K split over the largest cluster (at most
    `CLUSTER_MAX`) that keeps the launch within `DENSE_BLOCKS` blocks, so
    that all of them run at once; the whole share at once where it
    fits."""
    tiles = _ceil(cols, COL_TILE) * _ceil(rows, ROW_TILE)
    cluster = _cluster(tiles, DENSE_BLOCKS)
    cluster, share = _k_split(K, cluster)
    chunk, stages = _ring(share, lambda c, s: dense_smem(elem, first, concat,
                                                          c, s))
    return {"cluster": cluster, "k_share": share, "chunk": chunk,
            "stages": stages,
            "smem": dense_smem(elem, first, concat, chunk, stages),
            "grid": (cluster * _ceil(cols, COL_TILE), _ceil(rows, ROW_TILE)),
            "threads": THREADS}


def gru_smem(row_tile, chunk, stages, k_groups):
    """Dynamic shared bytes of a GRU block (csrc `gru_smem`): its stages
    of 6 x `GRU_UNITS` weight rows and its rows' states and embeddings, or
    the K groups' partial sums and then the cluster's partial sums of the
    elements the block owns, which take their place, whichever is more;
    1024 bytes to align the first to 1024."""
    stage = 4 * (6 * GRU_UNITS + 2 * row_tile) * chunk
    sums = 16 * (k_groups + 1) * row_tile * GRU_UNITS
    return max(stages * stage, sums) + 1024


@functools.lru_cache(maxsize=256)
def gru_plan(rows, H):
    """The launch plan of `decode_gru` for ``rows`` rows of hidden width H:
    {row_tile, k_groups, cluster, k_share, chunk, stages, smem, grid,
    threads}.  Blocks of 16, 32 or 64 rows x `GRU_UNITS` units, each
    thread 4 rows x 4 units, the rest of its `THREADS` splitting the chunk
    into K groups; K split over the largest cluster that keeps the launch
    within `GRU_BLOCKS` blocks (one an SM), shares and chunks multiples
    of the weights' boxes (`GRU_BOX`); the whole share at once where it
    fits in `GRU_SMEM` (two blocks an SM, so that a launch's clusters all
    run at once), else a ring of `GRU_STAGES`."""
    row_tile = 16 if rows <= 16 else 32 if rows <= 32 else 64
    k_groups = THREADS // ((row_tile // 4) * (GRU_UNITS // 4))
    tiles = _ceil(H, GRU_UNITS) * _ceil(rows, row_tile)
    cluster, share = _k_split(H, _cluster(tiles, GRU_BLOCKS), GRU_BOX)
    chunk, stages = _ring(share, lambda c, s: gru_smem(row_tile, c, s,
                                                        k_groups),
                          GRU_SMEM, GRU_BOX, GRU_STAGES)
    return {"row_tile": row_tile, "k_groups": k_groups, "cluster": cluster,
            "k_share": share, "chunk": chunk, "stages": stages,
            "smem": gru_smem(row_tile, chunk, stages, k_groups),
            "grid": (cluster * _ceil(H, GRU_UNITS), _ceil(rows, row_tile)),
            "threads": THREADS}


def _ceil16(n):
    return _ceil(n, 16) * 16


def select_smem(B, K, L, slots, stage):
    """(token bytes, warp bytes) of a select warp's dynamic shared memory
    (csrc `select_tok_bytes`, `select_cand_bytes`): its B token rows where
    ``stage``, then, where ``slots`` is 0, its B (K + 1) candidates'
    values, keys and label ids; each part rounded up to 16 bytes."""
    tok = _ceil16(4 * B * L) if stage else 0
    return tok, tok + (0 if slots else _ceil16(12 * B * (K + 1)))


@functools.lru_cache(maxsize=256)
def select_plan(N, B, K, L):
    """The launch plan of `decode_beam_select` for N samples of B beams, K
    labels a beam and L tokens a beam: {route, slots, stage, warps,
    tok_bytes, warp_bytes, smem, grid, threads}.  One warp a sample: its B
    (K + 1) candidates in lane registers (``slots`` a lane, the fewest of
    `SELECT_SLOTS` that hold them; route "registers") or, past 32 x 4, in
    shared memory (slots 0, route "shared"); its token rows staged in
    shared memory (``stage``) where a warp's share fits in `SELECT_SMEM`,
    else read in place; up to `SELECT_WARPS` samples a block, as many as
    `SELECT_SMEM` holds."""
    nc = B * (K + 1)
    slots = next((x for x in SELECT_SLOTS if 32 * x >= nc), 0)
    stage = 1
    tok, per = select_smem(B, K, L, slots, stage)
    if per > SELECT_SMEM:
        stage = 0
        tok, per = select_smem(B, K, L, slots, stage)
    warps = max(1, min(SELECT_WARPS, N, SELECT_SMEM // per if per
                       else SELECT_WARPS))
    return {"route": "registers" if slots else "shared", "slots": slots,
            "stage": stage, "warps": warps, "tok_bytes": tok,
            "warp_bytes": per, "smem": warps * per,
            "grid": _ceil(N, warps), "threads": 32 * warps}


def _plan_fields(plan):
    return (plan["cluster"], plan["k_share"], plan["chunk"], plan["stages"],
            plan["smem"])


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
    if _ceil(rows, ROW_TILE) > 65535:
        _fail(f"{rows} rows exceed the kernels' grid")
    elem = w_pre.element_size()
    concat = mode == "concat"
    plans = (dense_plan(rows, Fe + Fg if concat else Fe, H, elem, True,
                        concat),
             dense_plan(rows, H, V, elem, False))
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
    index = dev.index
    args = _JOINT_ARGS.pack(
        enc.data_ptr(), t.data_ptr(), p0.data_ptr(), pred_out.data_ptr(),
        w_pre.data_ptr(), b_pre.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), hid.data_ptr(), logits.data_ptr(),
        0 if logp_out is None else logp_out.data_ptr(),
        0 if best is None else best.data_ptr(), *beam, N, C, Fe, Fg, rows,
        H, V, int(concat), int(w_pre.dtype == torch.bfloat16),
        blank, k or 0, _build.raw_stream(index),
        *_plan_fields(plans[0]), *_plan_fields(plans[1]))
    _launch("decode_joint", args, index, "decode_joint")
    LAUNCHES["decode_joint"] += 3
    return out


def _put(new, into):
    """``new`` as returned, or copied into ``into`` (the ``into=`` route:
    the same values in the caller's tensors) and ``into`` returned."""
    if into is None:
        return tuple(new)
    for dst, x in zip(into, new):
        dst.copy_(x)
    return tuple(into)


def decode_gru_plain(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
                     src=None, into=None):
    """Plain torch version of `decode_gru`: the rows of ``src`` gathered
    (when given), `Predictor.step`'s embedding and ``torch.gru_cell``,
    then the decoders' ``torch.where`` on emit; with ``into``, written
    there."""
    if src is not None:
        h, out = h.index_select(0, src.long()), out.index_select(0, src.long())
    token = token.long()
    emb = F.embedding(token.clamp(min=0), embed)
    emb = torch.where(token[:, None] < 0, emb.new_zeros(()), emb)
    new = torch.gru_cell(emb, h, w_ih, w_hh, b_ih, b_hh)
    return _put((torch.where(emit[:, None], new, h),
                 torch.where(emit[:, None], new, out)), into)


def _fold(go, new, old):
    """The device loop's mask of a step: the new fields where ``go``
    (JAX's ``cond`` before the step), the old ones elsewhere."""
    return tuple(torch.where(go, n, o) for n, o in zip(new, old))


def decode_gru_greedy_plain(best, t, u, emitted_here, frame_bound, tokens,
                            h, out, embed, w_ih, w_hh, b_ih, b_hh, blank,
                            max_symbols, last_tok=None, count=None,
                            into=None):
    """Plain torch version of `decode_gru_greedy`: greedy's masked update
    (`models.decoding.greedy_drain`) around `decode_gru_plain`; with
    ``count``, then the loop's mask and count (`_fold`); with ``into``,
    written there."""
    new = _greedy_plain(best, t, u, emitted_here, frame_bound, tokens, h,
                        out, embed, w_ih, w_hh, b_ih, b_hh, blank,
                        max_symbols)
    if count is None:
        return _put(new, into)
    go = (t < frame_bound).any()
    return _put((*_fold(go, (*new, best),
                        (t, u, emitted_here, tokens, h, out, last_tok)),
                 count + go), into)


def _greedy_plain(best, t, u, emitted_here, frame_bound, tokens, h, out,
                  embed, w_ih, w_hh, b_ih, b_hh, blank, max_symbols):
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
    if gru_plan(max(rows, 1), H)["grid"][1] > 65535:
        _fail(f"{rows} rows exceed the kernel's grid")
    return rows, H


def _launch_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
                greedy=None, L=0, blank=0, max_symbols=0, src=None,
                fold=None, into=None):
    """One decode_gru launch; ``greedy`` = (t, u, emitted_here,
    frame_bound, tokens) folds greedy's update in, and ``fold`` =
    (last_tok, count) the loop's mask and count; ``src`` maps each row to
    the row of h and out it reads.  Returns (h', out', fields): with
    ``greedy``, fields = (t', u', emitted_here', tokens'), then with
    ``fold`` (last_tok', count').  ``into``: (h', out', *fields) written
    in those tensors (checked by the caller)."""
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
    if fold is not None:
        named += list(zip(("last_tok", "count"), fold))
    _ready(named, dev)
    if into is None:
        h_out, out_out = torch.empty_like(h), torch.empty_like(out)
    else:
        h_out, out_out = into[:2]
    ints = (0,) * 9
    fields = ()
    if greedy is not None:
        fields = (tuple(into[2:6]) if into is not None else
                  tuple(torch.empty_like(x) for x in (*greedy[:3], greedy[4])))
        ints = (*(x.data_ptr() for x in greedy),
                *(x.data_ptr() for x in fields))
    folds = (0,) * 4
    if fold is not None:
        new = (tuple(into[6:8]) if into is not None else
               tuple(torch.empty_like(x) for x in fold))
        folds = (fold[0].data_ptr(), new[0].data_ptr(), fold[1].data_ptr(),
                 new[1].data_ptr())
        fields += new
        if not rows:  # nothing to launch: no sample, so cond is false
            new[0].copy_(fold[0])
            new[1].copy_(fold[1])
    if rows:
        index = dev.index
        plan = gru_plan(rows, H)
        args = _GRU_ARGS.pack(
            token.data_ptr(), embed.data_ptr(), h.data_ptr(), out.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), 0 if emit is None else emit.data_ptr(),
            h_out.data_ptr(), out_out.data_ptr(), *ints, embed.shape[0],
            rows, H, L, blank, max_symbols, _build.raw_stream(index),
            0 if src is None else src.data_ptr(), *_plan_fields(plan),
            plan["row_tile"], plan["k_groups"], *folds)
        _launch("decode_gru", args, index, "decode_gru")
        LAUNCHES["decode_gru"] += 1
    return h_out, out_out, fields


def decode_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh,
               src=None, into=None):
    """h (rows, H), out (rows, H), token (rows,) int32, emit (rows,) bool,
    the GRU's fp32 parameters (embed (vocab, H); w_ih, w_hh (3H, H), gates
    r, z, n; b_ih, b_hh (3H,)), optionally src (rows,) int32 in [0, rows)
    -> (h', out'): row r's inputs are ``h[src[r]]`` and ``out[src[r]]``
    (row r without ``src``), the GRU cell where emit holds, those inputs
    elsewhere.  ``into`` = (h', out'): tensors to write them in (the
    device loop's static buffers; `out` names the predictor's output, so
    this is ``into``), returned; none may overlap an input.  A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    ins = (token, h, out, emit, embed, w_ih, w_hh, b_ih, b_hh, src)
    if into is not None:
        _check_into("decode_gru", into, (("h", h), ("out", out)), ins)
    if _build.on_cpu(h):
        return decode_gru_plain(token, h, out, emit, embed, w_ih, w_hh, b_ih,
                                b_hh, src, into)
    rows, _ = _gru_check(token, h, out, embed, w_ih, w_hh, b_ih, b_hh)
    for name, x, dtype in (("emit", emit, torch.bool),
                           ("src", src, torch.int32)):
        if x is not None and (tuple(x.shape) != (rows,) or x.dtype != dtype):
            _fail(f"{name} must be ({rows},) {dtype}, got {tuple(x.shape)}"
                  f" {x.dtype}")
    return _launch_gru(token, h, out, emit, embed, w_ih, w_hh, b_ih,
                       b_hh, src=src, into=into)[:2]


def _span(x):
    """[first, past the last) byte addresses a tensor may touch."""
    first = x.data_ptr()
    extent = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    return first, first + extent * x.element_size()


def _overlap(a, b):
    """True where tensors ``a`` and ``b`` may share a byte of memory."""
    if a.device != b.device or not a.numel() or not b.numel():
        return False
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def _check_into(what, into, like, inputs):
    """``into``: a tensor for each of ``like`` [(name, tensor)] of its
    shape and dtype, on its device, contiguous, none overlapping another
    or any of ``inputs`` (a kernel reads its inputs while it writes)."""
    if len(into) != len(like):
        _fail(f"{what}: into= holds {len(into)} tensors, not {len(like)}")
    for x, (name, ref) in zip(into, like):
        if (not isinstance(x, torch.Tensor) or x.shape != ref.shape
                or x.dtype != ref.dtype or x.device != ref.device):
            _fail(f"{what}: into's {name} must be {tuple(ref.shape)}"
                  f" {ref.dtype} on {ref.device}")
        if not x.is_contiguous():
            _fail(f"{what}: into's {name} must be contiguous")
        for y in (*inputs, *(z for z in into if z is not x)):
            if isinstance(y, torch.Tensor) and _overlap(x, y):
                _fail(f"{what}: into's {name} overlaps another argument")


def _count_check(count):
    if count.numel() != 1 or count.dtype != torch.int32:
        _fail(f"count must be one int32, got {tuple(count.shape)}"
              f" {count.dtype}")


def decode_gru_greedy(best, t, u, emitted_here, frame_bound, tokens, h, out,
                      embed, w_ih, w_hh, b_ih, b_hh, blank, max_symbols,
                      last_tok=None, count=None, into=None):
    """Greedy's step after the joint: best (N,) int32 (the joint's label),
    the state's t, u, emitted_here (N,) int32, tokens (N, L) int32, h and
    out (N, H), frame_bound (N,) int32 -> (t', u', emitted_here',
    tokens', h', out'), as `models.decoding.greedy_drain` updates them
    (`decode_gru_greedy_plain`).  With the state's last_tok (N,) int32
    and the loop's count (0-d int32), the loop's mask and count folded in
    (module docstring): (t', u', emitted_here', tokens', h', out',
    last_tok', count').  ``into``: a tensor for each of those outputs to
    write it in (`decode_gru`'s), returned.  A CUDA tensor launches the
    kernel, a CPU tensor runs the plain version."""
    if (last_tok is None) != (count is None):
        _fail("decode_gru_greedy folds the loop with both last_tok and"
              " count, or with neither")
    if into is not None:
        like = (("t", t), ("u", u), ("emitted_here", emitted_here),
                ("tokens", tokens), ("h", h), ("out", out))
        if count is not None:
            like += (("last_tok", last_tok), ("count", count))
        _check_into("decode_gru_greedy", into, like,
                    (best, t, u, emitted_here, frame_bound, tokens, h, out,
                     embed, w_ih, w_hh, b_ih, b_hh, last_tok, count))
    if _build.on_cpu(h):
        return decode_gru_greedy_plain(
            best, t, u, emitted_here, frame_bound, tokens, h, out, embed,
            w_ih, w_hh, b_ih, b_hh, blank, max_symbols, last_tok, count,
            into)
    rows, _ = _gru_check(best, h, out, embed, w_ih, w_hh, b_ih, b_hh)
    ints = [("t", t), ("u", u), ("emitted_here", emitted_here),
            ("frame_bound", frame_bound)]
    fold = None
    if count is not None:
        ints.append(("last_tok", last_tok))
        _count_check(count)
        fold = (last_tok, count)
    for name, x in ints:
        if tuple(x.shape) != (rows,) or x.dtype != torch.int32:
            _fail(f"{name} must be ({rows},) int32, got {tuple(x.shape)}"
                  f" {x.dtype}")
    if (tokens.dim() != 2 or tokens.shape[0] != rows
            or tokens.dtype != torch.int32):
        _fail(f"tokens must be ({rows}, L) int32, got {tuple(tokens.shape)}"
              f" {tokens.dtype}")
    order = None if into is None else (into[4], into[5], *into[:4],
                                       *into[6:])
    h_new, out_new, (t, u, emitted_here, tokens, *folded) = _launch_gru(
        best, h, out, None, embed, w_ih, w_hh, b_ih, b_hh,
        (t, u, emitted_here, frame_bound, tokens), tokens.shape[1], blank,
        max_symbols, fold=fold, into=order)
    return (t, u, emitted_here, tokens, h_new, out_new, *folded)


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
                             max_symbols, count=None, into=None):
    """Plain torch version of `decode_beam_select`: the beam-search
    step's torch code between the joint and the GRU, and after the GRU,
    as `models.beam_search.beam_drain` ran it; with ``count``, then the
    loop's mask and count (`_fold`: ``emit`` off and ``src`` the identity
    where the loop's ``cond`` is false, so that the GRU copies each row);
    with ``into``, the seven state fields (and the count) written
    there."""
    out = _select_plain(t, scores, tokens, u, nexp, waiting, hcode, lp_blank,
                        top_lp, top_ids, frame_bound, max_symbols)
    if count is not None:
        go = (t < frame_bound).any()
        ident = torch.arange(out[9].numel(), dtype=torch.int32,
                             device=tokens.device)
        out = (*_fold(go, out[:7], (t, scores, tokens, u, nexp, waiting,
                                    hcode)),
               out[7] & go, out[8], torch.where(go, out[9], ident),
               count + go)
    if into is None:
        return out
    state = _put(out[:7], into[:7])
    return (*state, *out[7:10],
            *(() if count is None else _put(out[10:], into[7:])))


def _select_plain(t, scores, tokens, u, nexp, waiting, hcode, lp_blank,
                  top_lp, top_ids, frame_bound, max_symbols):
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
                       top_lp, top_ids, frame_bound, max_symbols, count=None,
                       into=None):
    """The beam-search step between the joint and the GRU: the state's t
    (N,) int32, scores (N, B) fp32, tokens (N, B, L) int32, u and nexp
    (N, B) int32, waiting (N, B) bool, hcode (N, B) int64;
    `decode_joint`'s beam outputs lp_blank (N B,), top_lp (N B, K) fp32,
    top_ids (N B, K) int32; frame_bound (N,) int32; the emission cap ->
    (t', scores', tokens', u', nexp', waiting', hcode', emit (N B,) bool,
    new_tok (N B,) int32, src (N B,) int32: row n B + b's parent row),
    as `decode_beam_select_plain`, bit for bit; with the loop's ``count``
    (0-d int32), the loop's mask and count folded in (module docstring),
    count' last.  ``into``: tensors to write t' .. hcode' (and count') in
    (the device loop's static buffers), returned; none may overlap an
    input.  B and K at most `MAX_K`.  A CUDA tensor launches the kernel
    (`select_plan`), a CPU tensor runs the plain version.  On the card the
    kernel reads the state (t .. hcode, frame_bound) before it waits for
    the launch before it (the joint's): a kernel that writes them must not
    be the launch right before this one."""
    ins = (t, scores, tokens, u, nexp, waiting, hcode, lp_blank, top_lp,
           top_ids, frame_bound)
    if into is not None:
        like = tuple(zip(("t", "scores", "tokens", "u", "nexp", "waiting",
                          "hcode"), ins))
        _check_into("decode_beam_select", into,
                    like + ((("count", count),) if count is not None else ()),
                    (*ins, count))
    if _build.on_cpu(tokens):
        return decode_beam_select_plain(t, scores, tokens, u, nexp, waiting,
                                        hcode, lp_blank, top_lp, top_ids,
                                        frame_bound, max_symbols, count, into)
    N, B, L, K = _select_check(*ins)
    dev = tokens.device
    named = list(zip(("t", "scores", "tokens", "u", "nexp", "waiting",
                      "hcode", "lp_blank", "top_lp", "top_ids",
                      "frame_bound"), ins))
    if count is not None:
        _count_check(count)
        named.append(("count", count))
    _ready(named, dev)
    outs = (tuple(into[:7]) if into is not None
            else tuple(torch.empty_like(x) for x in ins[:7]))
    rows = N * B
    outs += (torch.empty((rows,), dtype=torch.bool, device=dev),
             torch.empty((rows,), dtype=torch.int32, device=dev),
             torch.empty((rows,), dtype=torch.int32, device=dev))
    folds = (0, 0)
    if count is not None:
        outs += (into[7] if into is not None else torch.empty_like(count),)
        folds = (count.data_ptr(), outs[-1].data_ptr())
        if not N:  # nothing to launch: no sample, so cond is false
            outs[-1].copy_(count)
    if N:
        index = dev.index
        plan = select_plan(N, B, K, L)
        args = _SELECT_ARGS.pack(
            *(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs[:10]),
            N, B, K, L, max_symbols, _build.raw_stream(index), *folds,
            plan["warps"], plan["slots"], plan["stage"], plan["smem"])
        _launch("decode_beam_select", args, index, "decode_beam_select")
        LAUNCHES["decode_beam_select"] += 1
    return outs


# The plain versions under the wrappers' names: a decoder's ``ops`` for a
# plain decode on any device (the card checks' reference).
PLAIN = types.SimpleNamespace(
    __name__="plain", decode_joint=decode_joint_plain,
    decode_gru=decode_gru_plain, decode_gru_greedy=decode_gru_greedy_plain,
    decode_beam_select=decode_beam_select_plain)
