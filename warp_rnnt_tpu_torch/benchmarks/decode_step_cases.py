"""The decode step's kernels on the card (`ops/decode_step.py`): their
cases and checks, shared by `chip_smoke.py` (phase 15) and the
`cuda`-marked tests of `tests/test_torch_decode_step.py`.  Each check
raises AssertionError on a failure and returns what it measured.

  * `record_states`: a plain greedy decode and a plain beam decode on the
    card (the step's plain versions, `decode_step.PLAIN`, in the eager
    loop), keeping the arguments of every ``every``-th call of each step
    function: the states the decoders visit.
  * `check_joint` / `check_gru`: one call through the kernel and through
    its plain version on the same arguments.  `decode_joint`: the rows'
    log-probs within `logp_tol` of the plain version's (fp32: `FP32_TOL`;
    bf16: that plus `BF16_ULPS` bf16 ulps of the row's largest |logit|,
    since cuBLAS and the kernel sum the products in other orders and a
    sum near a bf16 rounding boundary rounds the other way); the best
    label or the top-k ids equal wherever the plain version's margin to
    its neighbours exceeds twice that, and their values and the blank's
    log-prob within it.  `decode_gru`: the new state within `GRU_TOL`
    (fp32 sums in another order), non-emitting rows unchanged bit for
    bit, greedy's integer fields and token buffer equal.
  * `check_select`: one `decode_beam_select` call through the kernel and
    through its plain version: every output equal bit for bit.
  * `check_records`: every recorded joint and GRU call; `odd_cases`:
    seeded arguments at odd widths (H=200, V=29, 5, 37 and 111 rows, the
    concat joint) for both kernels in both dtypes.
    `check_select_records`: every recorded `decode_beam_select` call;
    `select_cases`: hand-built adversarial states (`select_state`: tied
    candidates, duplicate prefixes that merge, beams at the emission cap
    and at u = L, samples past their frame bound, all-NEG samples, fewer
    live candidates than beams) at B = 1, 4, 8 and `ODD`'s L and V.
  * `PARENT`: the step as it ran before `decode_beam_select`: the joint
    and the GRU on their kernels, the selection plain and the GRU's rows
    gathered by torch; `check_parent_path` holds a beam decode and a
    streaming beam session on the kernels equal to it, bit for bit.
  * `token_agreement`: whole decodes, plain against the kernels: the share
    of samples whose tokens are equal and the first position at which the
    others differ (reported, not gated: a step's logp moves by up to
    `logp_tol`, which can flip a near tie).
  * `kernel_times`: each kernel's device ms (`timing.bench_graph`) beside
    its plain version's on a recorded call; `gru_row_map_times`: a
    recorded beam `decode_gru` call without a row map, with the identity
    and with its parents' map, in turns.
"""

from __future__ import annotations

import types

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.models import beam_search, decoding
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop

FP32_TOL = 5e-5  # logp: two 512-term fp32 sums in another order, ~1e-6
BF16_ULPS = 4  # a logit's product and bias sum may each round one ulp away
GRU_TOL = 1e-5  # the GRU's new state, fp32
EVERY = 16  # record every 16th call: ~32 steps of a 500-step decode
# The odd widths: (rows, samples, k) at H=200, V=29, F=F'=200.
ODD = dict(H=200, V=29, Hp=200, C=7, L=11)
ODD_ROWS = ((5, 5, None), (37, 37, None), (15, 5, 3), (111, 37, 3))


def logp_tol(logits, dtype):
    """(rows, 1) allowed |logp kernel - logp plain| for the plain
    version's fp32 logits (rows, V) of a joint in ``dtype``."""
    tol = torch.full((logits.shape[0], 1), FP32_TOL, device=logits.device)
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * 2.0 ** -7 * logits.abs().amax(-1, keepdim=True)
    return tol


class Recorder:
    """The plain step functions, keeping the arguments of every
    ``every``-th call of each (references: the loop never writes a
    tensor in place)."""

    __name__ = "plain"

    def __init__(self, every=EVERY):
        self.every = every
        self.count = {"decode_joint": 0, "decode_gru": 0,
                      "decode_gru_greedy": 0, "decode_beam_select": 0}
        self.calls = {name: [] for name in self.count}

    def _keep(self, name, args):
        if self.count[name] % self.every == 0:
            self.calls[name].append(args)
        self.count[name] += 1

    def decode_joint(self, *args):
        self._keep("decode_joint", args)
        return ds.decode_joint_plain(*args)

    def decode_gru(self, *args, src=None):
        self._keep("decode_gru", args if src is None else (*args, src))
        return ds.decode_gru_plain(*args, src=src)

    def decode_beam_select(self, *args):
        # kept contiguous, as the kernels' joint gives them (the plain
        # joint's lp_blank is a column of its log-probs)
        self._keep("decode_beam_select", tuple(
            a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args))
        return ds.decode_beam_select_plain(*args)

    def decode_gru_greedy(self, *args):
        self._keep("decode_gru_greedy", args)
        return ds.decode_gru_greedy_plain(*args)


@torch.inference_mode()
def plain_decode(model, feats, xn, max_length, beam=0, ops=ds.PLAIN):
    """A whole decode on ``ops`` with the loop run eagerly: greedy
    (tokens, lengths), or beam ``beam`` (tokens, lengths, scores)."""
    enc = model.encode(feats)
    N = enc.shape[0]
    with device_loop._plain():
        if not beam:
            dec = decoding.greedy_state_init(model, N, max_length, ops=ops)
            dec = decoding.greedy_drain(model, dec, enc, 0, xn, ops=ops)
            return dec[6], dec[1]
        st = beam_search.beam_state_init(model, N, beam, max_length, ops=ops)
        st = beam_search.beam_drain(model, st, enc, 0, xn, ops=ops)
        return beam_search.beam_best(st)


def record_states(model, feats, xn, max_length, beam, every=EVERY):
    """Plain greedy and beam ``beam`` decodes recording their step calls:
    ({"greedy": Recorder, "beam": Recorder}, {"greedy": outputs, "beam":
    outputs})."""
    recs, outs = {}, {}
    for name, b in (("greedy", 0), ("beam", beam)):
        recs[name] = Recorder(every)
        outs[name] = plain_decode(model, feats, xn, max_length, b,
                                  recs[name])
    return recs, outs


def _sync(x):
    """Bring a fault of the kernels to light where it happened (on the
    CPU both sides are the plain version)."""
    if x.is_cuda:
        torch.cuda.synchronize()


def _margins(keys, width):
    """(rows, width): each of the ``width`` largest keys' distance to its
    nearer neighbour in the sorted order (the first: to the next only)."""
    top = keys.topk(min(width + 1, keys.shape[-1]), dim=-1).values
    gaps = top[:, :-1] - top[:, 1:]
    if gaps.shape[1] < width:
        gaps = torch.cat([gaps, gaps.new_full(
            (gaps.shape[0], width - gaps.shape[1]), float("inf"))], -1)
    before = torch.cat([gaps.new_full((gaps.shape[0], 1), float("inf")),
                        gaps[:, :width - 1]], -1)
    return torch.minimum(gaps[:, :width], before)


@torch.inference_mode()
def check_joint(args):
    """One `decode_joint` call (args as the decoders pass them: enc, t,
    p0, pred_out, w_pre, b_pre, w_out, b_out, mode, blank[, k]) through
    the kernel and the plain version.  Returns {max_abs_err (logp),
    err_share (of its tolerance), ids_held, ids_checked}."""
    from warp_rnnt_tpu_torch.models.joint import joint_logits

    enc, t, p0, pred_out, w_pre, b_pre, w_out, b_out, mode, blank = args[:10]
    k = args[10] if len(args) > 10 else None
    rows, V = pred_out.shape[0], w_out.shape[1]
    got_lp = torch.empty((rows, V), device=enc.device)
    want_lp = torch.empty_like(got_lp)
    got = ds.decode_joint(*args[:10], k, got_lp)
    want = ds.decode_joint_plain(*args[:10], k, want_lp)
    _sync(enc)
    N, _, Fe = enc.shape
    f = ds.frame_at(enc, t, p0)
    f = f[:, None, :].expand(N, rows // N, Fe).reshape(rows, Fe)
    params = {"w_pre": w_pre, "b_pre": b_pre, "w_out": w_out, "b_out": b_out}
    logits = joint_logits(f[:, None], pred_out[:, None], params, mode,
                          w_pre.dtype, normalize=False)[:, 0, 0]
    tol = logp_tol(logits, w_pre.dtype)
    err = (got_lp - want_lp).abs()
    r = {"max_abs_err": float(err.max()),
         "err_share": float((err / tol).max())}
    if not torch.isfinite(got_lp).all() or r["err_share"] > 1:
        raise AssertionError(f"decode_joint logp against the plain version:"
                             f" {r}")
    if k is None:
        sure = _margins(want_lp, 1)[:, 0] > 2 * tol[:, 0]
        bad = sure & (got != want)
    else:
        keys = want_lp.clone()
        keys[:, blank] = ds.NEG
        sure = _margins(keys, k) > 2 * tol
        bad = sure & (got[2] != want[2])
        if (got[0] - want[0]).abs().gt(tol[:, 0]).any():
            raise AssertionError("decode_joint: the blank's log-prob")
        same = got[2] == want[2]
        if ((got[1] - want[1]).abs().gt(tol) & same).any():
            raise AssertionError("decode_joint: a top-k value")
    if bad.any():
        raise AssertionError(f"decode_joint: {int(bad.sum())} ids differ"
                             " where the plain margin exceeds twice the"
                             " tolerance")
    r.update(ids_checked=int(sure.sum()), ids_held=int(sure.numel()))
    return r


def emit_mask(name, args):
    """The rows a `decode_gru` (``name`` "decode_gru") or
    `decode_gru_greedy` call with ``args`` writes: (rows,) bool."""
    if name == "decode_gru":
        return args[3]
    best, t, u, eh, fb, tokens = args[:6]
    blank, maxsym = args[13], args[14]
    return (t < fb) & (best != blank) & (u < tokens.shape[1]) & (eh < maxsym)


@torch.inference_mode()
def check_gru(name, args):
    """One `decode_gru` (``name`` "decode_gru") or `decode_gru_greedy`
    call through the kernel and the plain version.  Returns {max_abs_err
    (the emitting rows' state), rows, emitting}."""
    kernel = getattr(ds, name)
    plain = getattr(ds, f"{name}_plain")
    got, want = kernel(*args), plain(*args)
    _sync(args[6])
    emit = emit_mask(name, args)
    fields = ()
    if name == "decode_gru":
        h, out = args[1:3]
    else:
        h, out = args[6:8]
        fields = list(zip(("t", "u", "emitted_here", "tokens"), got[:4],
                          want[:4]))
        got, want = got[4:], want[4:]
    for field, g, w in fields:
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: {field} differs")
    if name == "decode_gru" and len(args) > 9:  # the rows each row reads
        h, out = h[args[9].long()], out[args[9].long()]
    h_new, out_new = got
    if not (torch.equal(h_new[~emit], h[~emit])
            and torch.equal(out_new[~emit], out[~emit])):
        raise AssertionError(f"{name}: a non-emitting row changed")
    if not torch.equal(h_new, out_new.where(emit[:, None], h_new)):
        raise AssertionError(f"{name}: the output is not the new state")
    err = float((h_new - want[0]).abs().max()) if emit.any() else 0.0
    if err > GRU_TOL:
        raise AssertionError(f"{name}: state error {err} > {GRU_TOL}")
    return {"max_abs_err": err, "rows": int(emit.numel()),
            "emitting": int(emit.sum())}


SELECT_FIELDS = ("t", "scores", "tokens", "u", "nexp", "waiting", "hcode",
                 "emit", "new_tok", "src")


def _bits(x):
    """A tensor's bits, so that equal NaNs compare equal."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@torch.inference_mode()
def check_select(args):
    """One `decode_beam_select` call (args as the beam body passes them)
    through the kernel and the plain version: every output bit for bit.
    Returns {max_abs_err (0.0), samples, beams, emitting, advanced}."""
    got = ds.decode_beam_select(*args)
    want = ds.decode_beam_select_plain(*args)
    _sync(args[2])
    for field, g, w in zip(SELECT_FIELDS, got, want):
        if g.dtype != w.dtype or not torch.equal(_bits(g), _bits(w)):
            raise AssertionError(f"decode_beam_select: {field} differs from"
                                 " the plain version")
    return {"max_abs_err": 0.0, "samples": int(args[0].numel()),
            "beams": int(want[1].numel()), "emitting": int(want[7].sum()),
            "advanced": int((want[0] != args[0]).sum())}


def check_records(recs):
    """Every recorded joint and GRU call of ``recs`` ({decoder:
    Recorder}; the selection's: `check_select_records`).  Returns
    {decoder: {function: {calls, max_abs_err, err_share or emitting}}}."""
    out = {}
    for dec, rec in recs.items():
        out[dec] = {}
        for name, calls in rec.calls.items():
            if not calls or name == "decode_beam_select":
                continue
            rs = [check_joint(a) if name == "decode_joint"
                  else check_gru(name, a) for a in calls]
            s = {"calls": len(rs),
                 "max_abs_err": max(r["max_abs_err"] for r in rs)}
            if name == "decode_joint":
                s["err_share"] = max(r["err_share"] for r in rs)
                s["ids_checked"] = sum(r["ids_checked"] for r in rs)
                s["ids_held"] = sum(r["ids_held"] for r in rs)
            else:
                s["emitting"] = sum(r["emitting"] for r in rs)
                s["rows"] = sum(r["rows"] for r in rs)
            out[dec][name] = s
    return out


def odd_args(seed, rows, samples, k, dtype, mode="add", device="cuda"):
    """Seeded arguments of both kernels at `ODD`'s widths: (joint args,
    gru args, greedy gru args or None)."""
    H, V, Hp, C, L = (ODD[x] for x in ("H", "V", "Hp", "C", "L"))
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(device)

    F_in = 2 * Hp if mode == "concat" else Hp
    enc = normal(samples, C, Hp)
    p0 = torch.tensor(3, dtype=torch.int32, device=device)
    t = ints(0, C + 6, samples)  # below, inside and past the chunk
    pred_out = normal(rows, Hp, scale=0.5)
    joint = (enc, t, p0, pred_out, normal(F_in, H, scale=F_in ** -0.5)
             .to(dtype), normal(H, scale=0.1).to(dtype),
             normal(H, V, scale=2 * H ** -0.5).to(dtype),
             normal(V, scale=0.1).to(dtype), mode, 2)
    if k is not None:
        joint = joint + (k,)
    params = (normal(V, Hp, scale=Hp ** -0.5),
              normal(3 * Hp, Hp, scale=Hp ** -0.5),
              normal(3 * Hp, Hp, scale=Hp ** -0.5), normal(3 * Hp, scale=0.1),
              torch.cat([torch.zeros(2 * Hp, device=device),
                         normal(Hp, scale=0.1)]))
    token = ints(-1, V, rows)  # -1: <sos>
    emit = ints(0, 2, rows).bool()
    gru = (token, pred_out, normal(rows, Hp), emit, *params)
    greedy = None
    if k is None:
        fb = ints(0, C + 6, rows)
        greedy = (ints(0, V, rows), t, ints(0, L + 1, rows), ints(0, 5, rows),
                  fb, ints(0, V, rows, L), pred_out, normal(rows, Hp),
                  *params, 2, 4)
    return joint, gru, greedy


def odd_cases(seed=0, device="cuda"):
    """Both kernels at `ODD`'s widths, each of `ODD_ROWS`, in bf16 and
    fp32, add and concat.  Returns {case: {kernel: result}}."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("add", "concat"):
            for i, (rows, samples, k) in enumerate(ODD_ROWS):
                joint, gru, greedy = odd_args(seed + i, rows, samples, k,
                                              dtype, mode, device)
                case = f"{str(dtype)[6:]} {mode} rows={rows} k={k}"
                out[case] = {"decode_joint": check_joint(joint),
                             "decode_gru": check_gru("decode_gru", gru)}
                if greedy is not None:
                    out[case]["decode_gru_greedy"] = check_gru(
                        "decode_gru_greedy", greedy)
    return out


def check_select_records(recs):
    """Every recorded `decode_beam_select` call of ``recs`` ({decoder:
    Recorder}).  Returns {decoder: {calls, max_abs_err, emitting,
    advanced}} for the decoders that made such calls."""
    out = {}
    for dec, rec in recs.items():
        rs = [check_select(a) for a in rec.calls["decode_beam_select"]]
        if rs:
            out[dec] = {"calls": len(rs), "max_abs_err": 0.0,
                        "emitting": sum(r["emitting"] for r in rs),
                        "advanced": sum(r["advanced"] for r in rs)}
    return out


# The adversarial states' samples (`select_state`), one kind each.
SELECT_SAMPLES = ("random", "tied", "dup_blank", "dup_emit", "capped",
                  "past_bound", "all_neg", "first_step", "few_live")
SELECT_MAX_SYMBOLS = 2
SELECT_BEAMS = (1, 4, 8)


def select_state(seed, B, device="cuda"):
    """`decode_beam_select`'s arguments for a hand-built state at `ODD`'s
    L and V, B beams, K = min(B, V - 1), one sample of each kind of
    `SELECT_SAMPLES`: random; every candidate tied; every beam of one
    hash, length and token row, so that their blanks (or their
    emissions) merge; beams at the emission cap and at u = L; the frame
    pointer at its bound; every beam at NEG; only beam 0 live (a fresh
    state); settled beams with -inf log-probs, so fewer candidates live
    than beams.  In the two duplicate samples the B picks are each
    beam's blank, or each beam's first label (one token): the merge
    keeps one of them.  Scores and log-probs are multiples of 1/8, so sums tie
    exactly."""
    L, V = ODD["L"], ODD["V"]
    K = min(B, V - 1)
    N = len(SELECT_SAMPLES)
    g = torch.Generator().manual_seed(seed)

    def eighths(lo, hi, *shape):
        return torch.randint(8 * lo, 8 * hi + 1, shape, generator=g) / 8.0

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    t = ints(0, 6, N)
    fb = t + ints(1, 4, N)
    scores = -eighths(0, 20, N, B)
    tokens = ints(0, V, N, B, L)
    u = ints(0, L + 1, N, B)
    nexp = ints(0, SELECT_MAX_SYMBOLS + 1, N, B)
    waiting = torch.randint(0, 2, (N, B), generator=g).bool()
    hcode = torch.randint(0, 2 ** 32, (N, B), generator=g)
    lp_blank = -eighths(0, 6, N, B)
    top_lp = (-eighths(0, 8, N, B, K)).sort(-1, descending=True).values
    top_ids = torch.stack([torch.randperm(V, generator=g)[:K].int()
                           for _ in range(N * B)]).reshape(N, B, K)
    kind = dict(zip(SELECT_SAMPLES, range(N)))
    n = kind["tied"]
    scores[n], lp_blank[n], top_lp[n] = -2.0, -1.0, -1.0
    waiting[n] = False
    # one prefix in every beam, scores within 2: each beam's blank (or,
    # in dup_emit, its first label, the same token everywhere) beats
    # every other candidate, so the B picks are one hypothesis
    for name, blank_lp, first_lp in (("dup_blank", 0.0, -4.0),
                                     ("dup_emit", -6.0, 0.0)):
        n = kind[name]
        hcode[n], u[n], nexp[n], waiting[n] = 12345, 3, 0, False
        tokens[n], top_ids[n] = tokens[n, :1].clone(), top_ids[n, :1].clone()
        scores[n] = -eighths(0, 2, B)
        lp_blank[n] = blank_lp
        top_lp[n] -= 4.0
        top_lp[n, :, 0] = first_lp
    n = kind["capped"]
    nexp[n, ::2], u[n, 1::2], waiting[n] = SELECT_MAX_SYMBOLS, L, False
    n = kind["past_bound"]
    fb[n] = t[n]
    n = kind["all_neg"]
    scores[n] = ds.NEG
    n = kind["first_step"]
    scores[n], scores[n, 0] = ds.NEG, 0.0
    u[n], nexp[n], waiting[n], hcode[n] = 0, 0, False, 0
    n = kind["few_live"]
    waiting[n, 0], waiting[n, 1:] = False, True
    u[n, B // 2:] = L
    lp_blank[n, 0] = -torch.inf
    top_lp[n, 0, K // 2:] = -torch.inf
    args = (t, scores, tokens, u, nexp, waiting, hcode,
            lp_blank.reshape(N * B), top_lp.reshape(N * B, K),
            top_ids.reshape(N * B, K), fb)
    return tuple(x.to(device) for x in args) + (SELECT_MAX_SYMBOLS,)


def select_cases(seed=0, device="cuda"):
    """`check_select` on `select_state` at each B of `SELECT_BEAMS`.
    Returns {"B=..": result}."""
    return {f"B={B}": check_select(select_state(seed + B, B, device))
            for B in SELECT_BEAMS}


def _parent_gru(token, h, out, emit, *params, src=None):
    """`decode_gru` after torch's gathers of the parents' rows."""
    if src is not None:
        h, out = h.index_select(0, src.long()), out.index_select(0, src.long())
    return ds.decode_gru(token, h, out, emit, *params)


# The beam step before `decode_beam_select`: its joint and GRU on the
# kernels, its selection, gathers, hash and merge in plain torch.
PARENT = types.SimpleNamespace(
    __name__="parent", decode_joint=ds.decode_joint, decode_gru=_parent_gru,
    decode_gru_greedy=ds.decode_gru_greedy,
    decode_beam_select=ds.decode_beam_select_plain)


def _beam_session(model, feats, xn, max_length, beam, C, ops):
    """A streaming beam session (chunks of C) driven here on the drains'
    ``ops``, as `streaming.stream_step` and `stream_finish` drive it on
    the kernels: (tokens, lengths, scores)."""
    from warp_rnnt_tpu_torch.models.streaming import _NO_LIMIT

    enc = model.encoder
    enc_st = enc.stream_init(feats.shape[0])
    dec = beam_search.beam_state_init(model, feats.shape[0], beam,
                                      max_length, ops=ops)
    xn = torch.as_tensor(xn, dtype=torch.int32, device=feats.device)
    for i in range(0, feats.shape[1], C):
        chunk = feats[:, i:i + C]
        enc_st, out, p0 = enc.stream(enc_st, chunk, _NO_LIMIT)
        bound = torch.minimum(xn, (p0 + chunk.shape[1]).clamp(min=0))
        dec = beam_search.beam_drain(model, dec, out, p0, bound, ops=ops)
    L = enc_st["m"]
    enc_st, out, p0 = enc.stream_finish(enc_st, L)
    dec = beam_search.beam_drain(model, dec, out, p0, torch.minimum(xn, L),
                                 ops=ops)
    return beam_search.beam_best(dec)


@torch.inference_mode()
def beam_outputs(model, feats, xn, max_length, beam, C, ops=None):
    """A whole beam decode and a streaming beam session (chunks of C) on
    ``ops`` (None: the public entry points, on the kernels): ((tokens,
    lengths, scores), (tokens, lengths, scores))."""
    from warp_rnnt_tpu_torch.models import streaming

    if ops is not None:
        enc = model.encode(feats)
        st = beam_search.beam_state_init(model, enc.shape[0], beam,
                                         max_length, ops=ops)
        return (beam_search.beam_best(beam_search.beam_drain(
            model, st, enc, 0, xn, ops=ops)),
            _beam_session(model, feats, xn, max_length, beam, C, ops))
    decode = beam_search.beam_decode(model, feats, xn, max_length,
                                     beam_size=beam)
    st = streaming.stream_init(model, feats.shape[0], max_length,
                               beam_size=beam)
    for i in range(0, feats.shape[1], C):
        st = streaming.stream_step(model, st, feats[:, i:i + C], xn=xn)
    return decode, streaming.stream_finish(model, st, xn=xn)[:3]


def check_parent_path(model, feats, xn, max_length, beam, C):
    """A beam decode and a streaming beam session on the kernels against
    the same on `PARENT`, bit for bit in tokens, lengths and scores.
    Returns {"decode": lengths, "session": lengths}."""
    got = beam_outputs(model, feats, xn, max_length, beam, C)
    want = beam_outputs(model, feats, xn, max_length, beam, C, PARENT)
    for what, g, w in zip(("decode", "session"), got, want):
        same = [torch.equal(_bits(a), _bits(b)) for a, b in zip(g, w)]
        if not all(same):
            raise AssertionError(f"beam {what} on the kernels != on the"
                                 f" parent's path: fields equal {same}")
    return {"decode": got[0][1].tolist(), "session": got[1][1].tolist()}


def token_agreement(model, feats, xn, max_length, beam, plain_outs):
    """Whole decodes on the kernels (graphed) against ``plain_outs``
    (`record_states`' plain decodes): {decoder: {"equal_share", "first":
    the first token position at which each differing sample differs}}."""
    from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode

    got = {"greedy": greedy_decode(model, feats, xn, max_length),
           "beam": beam_decode(model, feats, xn, max_length, beam_size=beam)}
    out = {}
    for name, (tok, ln, *_) in got.items():
        want_tok, want_ln = plain_outs[name][:2]
        same = (tok == want_tok).all(-1) & (ln == want_ln)
        first = []
        for n in (~same).nonzero()[:, 0].tolist():
            diff = (tok[n] != want_tok[n]).nonzero()
            first.append(int(diff[0]) if len(diff)
                         else int(min(ln[n], want_ln[n])))
        out[name] = {"equal_share": float(same.float().mean()),
                     "first": first}
    return out


@torch.inference_mode()
def kernel_times(call_joint, name, call_gru, calls=16, call_select=None):
    """Device ms (CUDA graph, L2 flushed) of one recorded `decode_joint`
    call, one ``name`` GRU call and, when given, one `decode_beam_select`
    call, each beside its plain version's: {kernel: {"ms", "plain_ms"}}."""
    out = {}
    kernels = [("decode_joint", ds.decode_joint, ds.decode_joint_plain,
                call_joint),
               ("decode_gru", getattr(ds, name), getattr(ds, f"{name}_plain"),
                call_gru)]
    if call_select is not None:
        kernels.append(("decode_beam_select", ds.decode_beam_select,
                        ds.decode_beam_select_plain, call_select))
    for kernel, fn, plain, args in kernels:
        out[kernel] = {"ms": timing.bench_graph(fn, args, calls),
                       "plain_ms": timing.bench_graph(plain, args, calls)}
    return out


@torch.inference_mode()
def gru_row_map_times(call, calls=16):
    """Device ms (CUDA graph, L2 flushed) of one recorded beam
    `decode_gru` call on its own inputs three ways: without a row map
    (``none``), with the identity map (``identity``) and with the
    recorded parents' map (``recorded``); each timed twice, in the order
    none, identity, recorded, recorded, identity, none: {way: [ms,
    ms]}."""
    args, src = call[:9], call[9]
    ident = torch.arange(src.numel(), dtype=torch.int32, device=src.device)
    ways = (("none", args), ("identity", (*args, ident)),
            ("recorded", (*args, src)))
    out = {way: [] for way, _ in ways}
    for way, a in (*ways, *ways[::-1]):
        out[way].append(timing.bench_graph(ds.decode_gru, a, calls))
    return out
