"""The serving path on the card: its cases and checks, shared by
`chip_smoke.py` (phase 15) and the `cuda`-marked tests of
`tests/test_torch_serving_card.py`.  Each check raises AssertionError on a
failure and returns what it measured.

  * `check_restricted`: `rnnt_loss_restricted` on the kernel path against
    ``impl="scan"`` on the same card (costs rtol COST_RTOL, gradients
    within GRAD_TOL of their largest), a huge band against `rnnt_loss` bit
    for bit, and the infeasible-band contract (+inf under 'none' with
    exactly zero and finite gradients, 'sum'/'mean' without the infeasible
    samples, an all-infeasible batch 0.0 with zero gradients).
  * `check_alignment`: `rnnt_alignment` on the card against the CPU
    (frames equal, scores rtol COST_RTOL) and the Viterbi score at most
    the full-sum log-likelihood.
  * `check_decoders`: beam 1 equals greedy; tokens in [1, V) and blank past
    each length; `beam_score_gaps`: each beam score at most the Viterbi
    score of its tokens re-scored on the model's full lattice
    (`viterbi_of`), on an fp32 model within SCORE_ATOL and the sums'
    fp32 rounding.
  * `check_streaming`: a chunked session equals the one-shot decode
    (tokens, lengths, and beam scores) exactly.
  * `check_card_equals_cpu`: a small fp32 model decodes to the same tokens
    on the card and on the CPU.
  * `check_graphed`: the decoders through the device loop's CUDA graphs
    against the plain loop (`device_loop._plain`, the same masked steps run
    eagerly on the card), bit for bit (tokens, lengths, scores), with the
    same trip count and at most iterations // unroll + 1 host reads a
    drain;
    `check_graphed_streaming` the same for chunked sessions;
    `check_graph_cache`: a second decode of one shape captures no graph,
    nor does one of another length that pads to the same width
    (`decoding.pad_frames`), and flipping TF32 captures one.
"""

from __future__ import annotations

import contextlib
import math

import torch

from warp_rnnt_tpu_torch.benchmarks.train_cases import flax_tree
from warp_rnnt_tpu_torch.functional.alignment import rnnt_alignment
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.functional.restricted import rnnt_loss_restricted
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    carry_flax_transducer,
    greedy_decode,
    stream_finish,
    stream_init,
    stream_step,
)
from warp_rnnt_tpu_torch.models.decoding import HOST_READS, LOOP_ITERATIONS
from warp_rnnt_tpu_torch.utils import device_loop

# The restricted loss and the alignment at the main path's shape (N=32,
# T=150, U=21, V=5000, fp32, full lengths), bands 15 left and 5 right.
RESTRICTED = dict(N=32, T=150, U=21, V=5000)
LEFT, RIGHT = 15, 5
COST_RTOL, GRAD_TOL = 1e-5, 5e-3
INFEASIBLE = (0, 1)  # samples whose bands are put out of order
# The kernels a restricted loss+grad (and a no-grad call) launches.
RESTRICTED_PATH = ("gather_lattice", "lattice_fused", "lattice_epilogue",
                   "flat_write")
RESTRICTED_NO_GRAD_PATH = ("gather_lattice", "lattice_beta_only")

# bench_decode.py's width and bench_streaming.py's.
DECODE = dict(N=32, T=400, F=80, H=512, V=1024, beam=4, max_length=100)
STREAM = dict(N=8, C=16, F=80, H=512, V=1024, beam=4, max_length=100, T=160)
# an fp32 beam score over the Viterbi score of its tokens, beside the
# rounding of the two sums (`beam_score_gaps`)
SCORE_ATOL = 1e-3
# A small fp32 model decoded on the card and on the CPU.
SMALL = dict(N=4, T=41, F=9, H=24, V=21, beam=3, max_length=30)


def counters():
    """The launch counts of every kernel wrapper."""
    from warp_rnnt_tpu_torch.benchmarks.train_cases import counters as train
    from warp_rnnt_tpu_torch.ops import decode_step, packed_kernels

    return [*train(), packed_kernels.LAUNCHES, decode_step.LAUNCHES]


def launched(fn):
    """Run ``fn()`` with every launch count set to 0 just before; returns
    (its result, {kernel: launches} of the kernels that ran)."""
    cs = counters()
    for c in cs:
        for k in c:
            c[k] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for c in cs for k, v in c.items() if v}


def restricted_inputs(seed, N, T, U, V, device="cuda"):
    """Seeded log_softmax log-probs (N, T, U, V), labels (N, U-1) in
    [1, V), full lengths, int32; and the label frames of their Viterbi
    alignment."""
    g = torch.Generator(device=device).manual_seed(seed)
    log_probs = torch.log_softmax(
        torch.randn(N, T, U, V, generator=g, device=device), dim=-1)
    labels = torch.randint(1, V, (N, U - 1), generator=g, device=device,
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device=device)
    yn = torch.full((N,), U - 1, dtype=torch.int32, device=device)
    _, frames = rnnt_alignment(log_probs, labels, xn, yn)
    return log_probs, labels, xn, yn, frames


def out_of_order(frames, samples=INFEASIBLE):
    """The frames with label 1 of each of ``samples`` put late and every
    later label at frame 0: no monotone path fits both bands."""
    bad = frames.clone()
    T_late = int(frames.max()) + LEFT + RIGHT + 2
    for n in samples:
        bad[n, 0] = T_late
        bad[n, 1:] = 0
    return bad


def _loss_grad(lp, labels, xn, yn, frames, reduction="none", impl="auto",
               left=LEFT, right=RIGHT):
    x = lp.detach().requires_grad_()
    costs = rnnt_loss_restricted(x, labels, xn, yn, frames, left, right,
                                 reduction=reduction, impl=impl)
    costs.sum().backward()
    return costs.detach(), x.grad


def _grad_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def check_restricted(lp, labels, xn, yn, frames):
    """The restricted loss on the card's kernel path: see the module
    docstring.  Returns {check: number} (errors relative to their
    allowance are named ``*_share``) and the launches of a loss+grad and of
    a no-grad call."""
    r = {}
    (costs, grad), launches = launched(
        lambda: _loss_grad(lp, labels, xn, yn, frames))
    if tuple(sorted(launches)) != tuple(sorted(RESTRICTED_PATH)):
        raise AssertionError(f"restricted loss+grad launched {launches}")
    with torch.no_grad():
        costs_ng, launches_ng = launched(lambda: rnnt_loss_restricted(
            lp, labels, xn, yn, frames, LEFT, RIGHT))
    if tuple(sorted(launches_ng)) != tuple(sorted(RESTRICTED_NO_GRAD_PATH)):
        raise AssertionError(f"restricted no-grad launched {launches_ng}")
    costs_s, grad_s = _loss_grad(lp, labels, xn, yn, frames, impl="scan")
    if not (torch.isfinite(costs).all() and torch.isfinite(grad).all()):
        raise AssertionError("restricted: non-finite costs or gradients")
    r["costs_vs_scan"] = float(((costs - costs_s).abs()
                                / costs_s.abs()).max())
    r["no_grad_vs_scan"] = float(((costs_ng - costs_s).abs()
                                  / costs_s.abs()).max())
    r["grad_vs_scan_share"] = _grad_err(grad, grad_s) / GRAD_TOL
    del grad_s
    if max(r["costs_vs_scan"], r["no_grad_vs_scan"]) > COST_RTOL:
        raise AssertionError(f"restricted costs against the scan: {r}")
    if r["grad_vs_scan_share"] > 1:
        raise AssertionError(f"restricted gradients against the scan: {r}")
    unres = rnnt_loss(lp, labels, xn, yn)
    if not (costs >= unres - COST_RTOL * unres.abs()).all():
        raise AssertionError("restricted costs below the unrestricted")

    # a band wider than the lattice is the unrestricted loss, bit for bit
    wide = lp.shape[1] + lp.shape[2]
    costs_w, grad_w = _loss_grad(lp, labels, xn, yn, frames, left=wide,
                                 right=wide)
    x = lp.detach().requires_grad_()
    c_u = rnnt_loss(x, labels, xn, yn, gather=True)
    c_u.sum().backward()
    if not (torch.equal(costs_w, c_u.detach()) and torch.equal(grad_w, x.grad)):
        raise AssertionError("huge band: not the unrestricted loss bit for bit")
    del grad_w, x

    # infeasible bands: +inf, exactly zero and finite gradients
    bad = out_of_order(frames)
    keep = [n for n in range(lp.shape[0]) if n not in INFEASIBLE]
    costs_b, grad_b = _loss_grad(lp, labels, xn, yn, bad)
    if not (torch.isposinf(costs_b[list(INFEASIBLE)]).all()
            and torch.isfinite(costs_b[keep]).all()):
        raise AssertionError(f"infeasible costs: {costs_b[:4].tolist()}")
    if not (torch.isfinite(grad_b).all()
            and (grad_b[list(INFEASIBLE)] == 0).all()
            and (grad_b[keep[0]] != 0).any()):
        raise AssertionError("infeasible gradients not zero and finite")
    with torch.no_grad():
        from warp_rnnt_tpu_torch.functional.core import rnnt_core
        from warp_rnnt_tpu_torch.functional.loss import _gather_blank_emit
        from warp_rnnt_tpu_torch.functional.restricted import band_mask

        raw = rnnt_core(band_mask(_gather_blank_emit(lp, labels, 0), bad,
                                  LEFT, RIGHT), xn, yn)
    r["infeasible_raw_cost"] = float(raw[INFEASIBLE[0]])
    for red in ("sum", "mean"):
        got, g = _loss_grad(lp, labels, xn, yn, bad, reduction=red)
        want = costs_b[keep].sum() if red == "sum" else costs_b[keep].mean()
        if not torch.allclose(got, want, rtol=1e-6, atol=0):
            raise AssertionError(f"{red} over feasible: {float(got)}"
                                 f" != {float(want)}")
        if not (torch.isfinite(g).all() and (g[list(INFEASIBLE)] == 0).all()):
            raise AssertionError(f"{red}: infeasible gradients not zero")
    every = out_of_order(frames, range(lp.shape[0]))
    got, g = _loss_grad(lp, labels, xn, yn, every, reduction="mean")
    if float(got) != 0.0 or not (g == 0).all():
        raise AssertionError("all-infeasible batch: not 0 with zero gradients")
    return r, launches, launches_ng


def check_alignment(lp, labels, xn, yn, costs):
    """The alignment on the card against the CPU: frames equal, scores
    rtol COST_RTOL; each Viterbi score at most -cost (``costs`` from the
    kernel path).  Returns (scores, frames, largest score error)."""
    scores, frames = rnnt_alignment(lp, labels, xn, yn)
    s_cpu, f_cpu = rnnt_alignment(lp.cpu(), labels.cpu(), xn.cpu(), yn.cpu())
    if not torch.equal(frames.cpu(), f_cpu):
        raise AssertionError("alignment frames: card != CPU")
    err = float(((scores.cpu() - s_cpu).abs() / s_cpu.abs()).max())
    if err > COST_RTOL:
        raise AssertionError(f"alignment scores: card vs CPU rtol {err}")
    if not (scores <= -costs + COST_RTOL * costs.abs()).all():
        raise AssertionError("a Viterbi score above the log-likelihood")
    return scores, frames, err


def carried_model(d, seed, device="cuda", compute_dtype=torch.bfloat16):
    """A `Transducer` at ``d``'s widths, carried from `flax_tree`."""
    return carry_flax_transducer(flax_tree(seed, d["V"], d["F"], d["H"]),
                                 device=device, compute_dtype=compute_dtype)


def features(seed, N, T, F, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((N, T, F), generator=gen).to(device)


def ragged(N, T, device="cuda"):
    """Valid lengths from T down (the first sample full), int32."""
    xn = [T - (i * T) // (2 * N) for i in range(N)]
    return torch.tensor(xn, dtype=torch.int32, device=device)


def viterbi_of(model, feats, xn, tokens, lengths):
    """The Viterbi score of each sample's tokens[:length] on the model's
    full (N, T, L + 1, V) lattice.  The predictor rows come from the
    decoders' own `predictor_step` (the GRU cell a token), not from the
    sequence GRU of `Transducer.forward` (cuDNN's, whose fp32 sums differ
    from the cell's by ~1e-4 a log-prob after 100 steps)."""
    N = tokens.shape[0]
    L = max(int(lengths.max()), 1)
    ys = tokens[:, :L].contiguous()
    with torch.inference_mode():
        state = model.predictor_init(N)
        g = []
        for tok in (torch.full_like(ys[:, 0], -1), *ys.unbind(1)):
            state, out = model.predictor_step(state, tok)
            g.append(out)
        lp = model.joint(model.encode(feats), torch.stack(g, 1))
    scores, _ = rnnt_alignment(lp, ys, xn, lengths)
    return scores


@contextlib.contextmanager
def tf32(on):
    """cuBLAS's and cuDNN's TF32 flags set to ``on`` within the block."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = on
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def no_tf32():
    """fp32 products and convolutions in fp32 on the card: cuDNN's
    convolutions take TF32 unless told not to."""
    return tf32(False)


def check_decoders(model, feats, xn, V, beam, max_length):
    """Beam 1 equals greedy; beam ``beam``'s tokens in [1, V) below each
    length and blank past it, lengths <= max_length, scores finite.
    Returns (greedy lengths, beam (tokens, lengths, scores))."""
    g_tok, g_len = greedy_decode(model, feats, xn, max_length)
    b1 = beam_decode(model, feats, xn, max_length, beam_size=1)
    if not (torch.equal(g_len, b1[1]) and torch.equal(g_tok, b1[0])):
        raise AssertionError("beam 1 != greedy")
    tok, ln, sc = beam_decode(model, feats, xn, max_length, beam_size=beam)
    pos = torch.arange(max_length, device=tok.device)[None, :]
    live = pos < ln[:, None]
    if not ((ln <= max_length).all() and (tok[live] >= 1).all()
            and (tok[live] < V).all() and (tok[~live] == 0).all()
            and torch.isfinite(sc).all()):
        raise AssertionError("beam tokens or lengths out of range")
    return g_len, (tok, ln, sc)


def beam_score_gaps(model, feats, xn, beam_out, atol=None):
    """Each beam score minus the Viterbi score of its tokens on the model's
    full lattice (`viterbi_of`): a beam score is one alignment of its
    tokens, so at most that, but for rounding.  With ``atol``, raises
    where a gap exceeds ``atol`` + 2 (xn + length) 2^-24 |score|: the
    worst-case rounding of the two fp32 sums of xn + length log-probs
    (the beam's running sum and the Viterbi scan's).  That holds on an
    fp32 model (``beam_out`` decoded without TF32), whose decode and full
    lattice compute the same log-probs but for fp32 rounding; a bf16
    model's joint rounds to bf16 by row count (N x B rows a step against
    N x T x U), ~1e-2 over a path.  Returns (largest gap, smallest gap,
    largest gap over its allowance)."""
    tok, ln, sc = beam_out
    with no_tf32():
        gap = sc - viterbi_of(model, feats, xn, tok, ln)
    allow = (atol or 0.0) + 2 * (xn + ln).float() * 2.0 ** -24 * sc.abs()
    share = float((gap / allow).max())
    if atol is not None and share > 1:
        raise AssertionError(f"a beam score above its Viterbi score: {gap}"
                             f" (allowance {allow})")
    return float(gap.max()), float(gap.min()), share


def stream_all(model, feats, C, xn, max_length, beam=0):
    """Feed feats in chunks of C (the last one ragged), then finish."""
    N, T, _ = feats.shape
    st = stream_init(model, N, max_length, beam_size=beam)
    for i in range(0, T, C):
        st = stream_step(model, st, feats[:, i:i + C], xn=xn)
    return stream_finish(model, st, xn=xn)[:-1]


@torch.inference_mode()
def encoder_bits_differing(model, feats, C):
    """Elements of the chunked encoder's frames (chunks of C, then the
    flush) that differ from the whole-utterance encoder's."""
    N, T, _ = feats.shape
    full = model.encode(feats)
    got = torch.full_like(full, float("nan"))
    enc = model.encoder
    st = enc.stream_init(N)

    def put(out, p0):
        p0 = int(p0)
        lo, hi = max(p0, 0), min(p0 + out.shape[1], T)
        if lo < hi:
            got[:, lo:hi] = out[:, lo - p0:hi - p0]

    for i in range(0, T, C):
        st, out, p0 = enc.stream(st, feats[:, i:i + C], 2 ** 30)
        put(out, p0)
    put(*enc.stream_finish(st, st["m"])[1:])
    return int((got != full).sum())


def check_streaming(model, feats, xn, max_length, beam, chunks):
    """Chunked sessions against the one-shot decode, exactly: greedy, and
    beam ``beam`` (scores too), at each C of ``chunks``.  Returns
    ({beam: one-shot lengths}, {C: encoder elements differing})."""
    ref = {0: greedy_decode(model, feats, xn, max_length),
           beam: beam_decode(model, feats, xn, max_length, beam_size=beam)}
    for b, want in ref.items():
        for C in chunks:
            got = stream_all(model, feats, C, xn, max_length, b)
            same = [torch.equal(g, w) for g, w in zip(got, want)]
            if not all(same):
                raise AssertionError(f"stream beam={b} C={C}: tokens,"
                                     f" lengths[, scores] equal {same}")
    bits = {C: encoder_bits_differing(model, feats, C) for C in chunks}
    return {b: w[1].tolist() for b, w in ref.items()}, bits


def check_card_equals_cpu(seed=0, d=SMALL):
    """A small fp32 model, greedy and beam, on the card and on the CPU:
    the same tokens and lengths.  Returns the largest beam score gap."""
    out = {}
    for dev in ("cuda", "cpu"):
        model = carried_model(d, seed, dev, torch.float32)
        feats = features(seed + 1, d["N"], d["T"], d["F"], dev)
        xn = ragged(d["N"], d["T"], dev)
        with no_tf32():
            out[dev] = (greedy_decode(model, feats, xn, d["max_length"]),
                        beam_decode(model, feats, xn, d["max_length"],
                                    beam_size=d["beam"]))
    (g_c, b_c), (g_h, b_h) = out["cuda"], out["cpu"]
    for name, got, want in (("greedy", g_c, g_h), ("beam", b_c[:2], b_h[:2])):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: card tokens != CPU tokens")
    return float((b_c[2].cpu() - b_h[2]).abs().max())


def _counted(name, fn, plain=False):
    """fn() -> (its result, its loop's trip count, host reads), with the
    counts of decoder ``name`` set to 0 just before; ``plain`` runs the
    loop eagerly on the card (`device_loop._plain`)."""
    LOOP_ITERATIONS[name] = HOST_READS[name] = 0
    with device_loop._plain() if plain else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, LOOP_ITERATIONS[name], HOST_READS[name]


def _hold_graphed(tag, name, fn, drains=1):
    """The graphed call against the plain one: bit for bit, one trip
    count, and at most iterations // unroll + ``drains`` host reads (a
    drain of n iterations reads max(1, ceil(n / unroll)) times, at most
    n / unroll + 1)."""
    want, it_plain, reads_plain = _counted(name, fn, plain=True)
    got, it, reads = _counted(name, fn)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    if not all(same):
        raise AssertionError(f"{tag}: graphed != plain, fields equal {same}")
    if it != it_plain:
        raise AssertionError(f"{tag}: {it} iterations graphed, {it_plain}"
                             " plain")
    if reads > it // device_loop.UNROLL + drains:
        raise AssertionError(f"{tag}: {reads} host reads for {it}"
                             f" iterations at unroll {device_loop.UNROLL}")
    return {"iterations": it, "host_reads": reads,
            "plain_host_reads": reads_plain}


def check_graphed(model, feats, xn, max_length, beam):
    """Greedy and beam ``beam`` through the graphs against the plain loop
    (see `_hold_graphed`).  Returns {decoder: {iterations, host_reads,
    plain_host_reads}}."""
    return {
        "greedy": _hold_graphed("greedy", "greedy", lambda: greedy_decode(
            model, feats, xn, max_length)),
        "beam": _hold_graphed(f"beam {beam}", "beam", lambda: beam_decode(
            model, feats, xn, max_length, beam_size=beam))}


def check_graphed_streaming(model, feats, xn, max_length, beam, chunks):
    """Chunked sessions (chunks of each C in ``chunks``), greedy and beam
    ``beam``, through the graphs against the plain loop, bit for bit, the
    trip counts summed over the session.  Returns {"greedy C=..": counts}."""
    out = {}
    for b, name in ((0, "greedy"), (beam, "beam")):
        for C in chunks:
            out[f"{name} C={C}"] = _hold_graphed(
                f"stream {name} C={C}", name,
                lambda: stream_all(model, feats, C, xn, max_length, b),
                drains=math.ceil(feats.shape[1] / C) + 1)
    return out


def check_graph_cache(model, feats, xn, max_length):
    """A greedy decode, then another of the same shape: no new graph;
    then one of the utterances cut to the least length that pads to the
    same width: no new graph; then one with cuBLAS's and cuDNN's TF32
    flags flipped: one new graph (the flags change the products' bits, so
    they key the cache).  Returns the captures of (second decode, shorter
    decode, flipped decode)."""
    T = feats.shape[1]
    short = (1 << max(T - 1, 0).bit_length()) // 2 + 1

    def decode(T=T):
        return greedy_decode(model, feats[:, :T], xn.clamp(max=T),
                             max_length)

    decode()
    counts = [device_loop.STATS["captures"]]
    decode()
    counts.append(device_loop.STATS["captures"])
    decode(short)
    counts.append(device_loop.STATS["captures"])
    with tf32(not torch.backends.cuda.matmul.allow_tf32):
        decode()
    counts.append(device_loop.STATS["captures"])
    new = tuple(b - a for a, b in zip(counts, counts[1:]))
    if new != (0, 0, 1):
        raise AssertionError(f"captures: {new[0]} for the same shape,"
                             f" {new[1]} at length {short} of {T}, {new[2]}"
                             " after flipping TF32")
    return new
