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
    concat joint) for both kernels in both dtypes; `wide_cases`: the same
    at a wide model's widths (`WIDE`: hidden 1024, V=5000, 16 and 64
    rows) and at widths whose K shares take a ring of stages (`RING`).
    `check_deterministic`: two calls of each kernel, bit for bit (the
    clusters add their partial sums in a fixed order).  `pdl_edges`: the
    programmatic edges of a captured step's graph.
    `check_select_records`: every recorded `decode_beam_select` call;
    `select_cases`: hand-built adversarial states (`select_state`: tied
    candidates, duplicate prefixes that merge, beams at the emission cap
    and at u = L, samples past their frame bound, all-NEG samples, fewer
    live candidates than beams) at B = 1, 4, 8 and `ODD`'s L and V.
  * `PARENT`: the step as it ran before `decode_beam_select`: the joint
    and the GRU on their kernels, the selection plain and the GRU's rows
    gathered by torch; `check_parent_path` holds a beam decode and a
    streaming beam session on the kernels equal to it, bit for bit.
  * The loop's mask and count folded into `decode_gru_greedy` and
    `decode_beam_select` (`fold_args`: the count, greedy's last_tok, and
    frame bounds that set the loop's ``cond`` true or false):
    `check_gru` / `check_select` with ``go`` (the folded kernel against
    its folded plain version, the integers and the selection bit for bit,
    and greedy's state against the unfolded kernel's bit for bit),
    `check_fold_records` on every recorded call, `odd_cases` (so also
    `wide_cases`) and `select_fold_cases` with ``cond`` true and false;
    `check_fold`: the folded drains, greedy, beam and streaming sessions
    of both (`_session`), graphed, against `UNFOLDED` (the same kernels
    under the loop's own mask) eager and graphed, the whole state bit for
    bit; `step_edges`: one and two captured folded steps' edges, and
    whether the edge from a step's GRU to the next step's hidden layer is
    programmatic.
  * `token_agreement`: whole decodes, plain against the kernels: the share
    of samples whose tokens are equal and the first position at which the
    others differ (reported, not gated: a step's logp moves by up to
    `logp_tol`, which can flip a near tie).
  * `kernel_times`: each kernel's device ms (`timing.bench_graph`) with
    L2 warm (as the decode loop finds its weights) and flushed, in turns
    with `BASELINE`'s (the step's first kernels, `csrc/
    decode_step_baseline.cu`), beside its plain version's and the
    yardsticks the port never calls (a bf16 `F.linear` per dense layer, a
    `torch.gru_cell` on embedded rows); `gru_row_map_times`: a recorded
    beam `decode_gru` call without a row map, with the identity and with
    its parents' map, in turns.  `step_times`: the graphed greedy and beam
    step's device us and each kernel's us in the step (a replay's
    profile), on `BASELINE` and on the kernels (or on `UNFOLDED` and on
    the kernels folded), in turns.
"""

from __future__ import annotations

import math
import types

import torch
from torch.nn import functional as F

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
# A wide model (hidden 1024, V=5000) at 16 and 64 rows; and widths whose K
# shares do not fit in shared memory (the joint's K = 8192 add, 16384
# concat; the GRU's Hg = 2048), so the dense and GRU kernels run a ring.
WIDE = dict(H=1024, V=5000, Hp=1024, C=7, L=11)
WIDE_ROWS = ((16, 16, None), (64, 64, None), (64, 16, 4))
RING = dict(H=64, V=40, Hp=8192, Hg=2048, C=3, L=5)
RING_ROWS = ((16, 16, None), (64, 16, 4))


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


def fold_args(name, args, go):
    """A ``name`` ("decode_gru_greedy" or "decode_beam_select") call's
    arguments with the device loop's fold, its frame bounds set so that
    the loop's ``cond`` is ``go`` (True: as given, or one sample's bound
    past its frame pointer where none was; False: every bound at its
    pointer), then greedy's ``last_tok`` (other than the joint's label)
    and the loop's count (0-d int32)."""
    args = list(args)
    ti, at = (1, 4) if name == "decode_gru_greedy" else (0, 10)
    t, fb = args[ti], args[at]
    if not go:
        fb = t.clone()
    elif not bool((t < fb).any()):
        fb = fb.clone()
        fb[0] = t[0] + 1
    args[at] = fb
    count = torch.tensor(5, dtype=torch.int32, device=t.device)
    if name == "decode_gru_greedy":
        return (*args, (args[0].flip(0) + 1).contiguous(), count)
    return (*args, count)


def emit_mask(name, args):
    """The rows a `decode_gru` (``name`` "decode_gru") or
    `decode_gru_greedy` call with ``args`` writes: (rows,) bool."""
    if name == "decode_gru":
        return args[3]
    best, t, u, eh, fb, tokens = args[:6]
    blank, maxsym = args[13], args[14]
    return (t < fb) & (best != blank) & (u < tokens.shape[1]) & (eh < maxsym)


@torch.inference_mode()
def check_gru(name, args, go=None):
    """One `decode_gru` (``name`` "decode_gru") or `decode_gru_greedy`
    call through the kernel and the plain version; with ``go`` (greedy
    only), folded with the loop's ``cond`` set to it (`fold_args`), and
    then also last_tok and the count equal, and (``go`` True) the state
    equal to the unfolded kernel's bit for bit.  Returns {max_abs_err
    (the emitting rows' state), rows, emitting}."""
    kernel = getattr(ds, name)
    plain = getattr(ds, f"{name}_plain")
    if go is not None:
        args = fold_args(name, args, go)
    got, want = kernel(*args), plain(*args)
    _sync(args[6])
    emit = emit_mask(name, args)
    fields = ()
    if name == "decode_gru":
        h, out = args[1:3]
    else:
        h, out = args[6:8]
        names = ("t", "u", "emitted_here", "tokens")
        if go is not None:
            names += (None, None, "last_tok", "count")
        fields = [f for f in zip(names, got, want) if f[0]]
        if go:
            unfolded = kernel(*args[:15])[4:6]
            if not all(torch.equal(a, b) for a, b in zip(got[4:6], unfolded)):
                raise AssertionError(f"{name}: folded state != unfolded")
        got, want = got[4:6], want[4:6]
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


def _same_outputs(what, got, want, fields):
    if len(got) != len(want):
        raise AssertionError(f"{what}: outputs differ in number")
    for field, g, w in zip(fields, got, want):
        if g.dtype != w.dtype or not torch.equal(_bits(g), _bits(w)):
            raise AssertionError(f"{what}: {field} differs")


def _into_like(outs, n):
    """Fresh tensors for the first ``n`` of ``outs``, filled with a value
    no output holds at every element (the ``into=`` route must write all
    of them)."""
    return tuple(torch.full_like(x, 7) for x in outs[:n])


@torch.inference_mode()
def check_select(args, go=None):
    """One `decode_beam_select` call (args as the beam body passes them)
    through the kernel and the plain version: every output bit for bit;
    with ``go``, folded with the loop's ``cond`` set to it (`fold_args`),
    the count too; then the kernel again with ``into=`` (the device loop's
    route: the state and count written into given tensors), equal to its
    fresh outputs bit for bit.  The inputs were made by other kernels, so
    the device is synchronized first: the kernel reads the state before it
    waits for the launch before it.  Returns {max_abs_err (0.0), samples,
    beams, emitting, advanced}."""
    if go is not None:
        args = fold_args("decode_beam_select", args, go)
    _sync(args[2])
    got = ds.decode_beam_select(*args)
    want = ds.decode_beam_select_plain(*args)
    _sync(args[2])
    fields = (*SELECT_FIELDS, "count")
    _same_outputs("decode_beam_select against the plain version", got, want,
                  fields)
    n = 7 if go is None else 8
    into = _into_like((*got[:7], *got[10:]), n)
    _sync(args[2])
    put = ds.decode_beam_select(*args, into=into)
    _sync(args[2])
    if not all(a is b for a, b in zip((*put[:7], *put[10:]), into)):
        raise AssertionError("decode_beam_select: into= not returned")
    _same_outputs("decode_beam_select with into=", put, got, fields)
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


def check_fold_records(recs):
    """Every recorded `decode_gru_greedy` and `decode_beam_select` call of
    ``recs`` ({decoder: Recorder}) folded, with the loop's ``cond`` true
    and false (`check_gru`, `check_select` with ``go``).  Returns
    {decoder: {function: {calls, max_abs_err, emitting}}}."""
    out = {}
    for dec, rec in recs.items():
        for name in ("decode_gru_greedy", "decode_beam_select"):
            calls = rec.calls[name]
            if not calls:
                continue
            rs = [check_gru(name, a, go) if name == "decode_gru_greedy"
                  else check_select(a, go)
                  for a in calls for go in (True, False)]
            out.setdefault(dec, {})[name] = {
                "calls": len(rs),
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "emitting": sum(r["emitting"] for r in rs)}
    return out


def odd_args(seed, rows, samples, k, dtype, mode="add", device="cuda",
             dims=ODD):
    """Seeded arguments of both kernels at ``dims``' widths (the joint's
    hidden H, vocabulary V, input width Hp, frames C, token buffer L; the
    GRU's width Hg, Hp where absent): (joint args, gru args, greedy gru
    args or None)."""
    H, V, Hp, C, L = (dims[x] for x in ("H", "V", "Hp", "C", "L"))
    Hg = dims.get("Hg", Hp)
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
    params = (normal(V, Hg, scale=Hg ** -0.5),
              normal(3 * Hg, Hg, scale=Hg ** -0.5),
              normal(3 * Hg, Hg, scale=Hg ** -0.5), normal(3 * Hg, scale=0.1),
              torch.cat([torch.zeros(2 * Hg, device=device),
                         normal(Hg, scale=0.1)]))
    state = pred_out if Hg == Hp else normal(rows, Hg, scale=0.5)
    token = ints(-1, V, rows)  # -1: <sos>
    emit = ints(0, 2, rows).bool()
    gru = (token, state, normal(rows, Hg), emit, *params)
    greedy = None
    if k is None:
        fb = ints(0, C + 6, rows)
        greedy = (ints(0, V, rows), t, ints(0, L + 1, rows), ints(0, 5, rows),
                  fb, ints(0, V, rows, L), state, normal(rows, Hg),
                  *params, 2, 4)
    return joint, gru, greedy


def odd_cases(seed=0, device="cuda", dims=ODD, rows_list=ODD_ROWS):
    """Both kernels at ``dims``' widths (default `ODD`'s), each of
    ``rows_list`` (rows, samples, k), in bf16 and fp32, add and concat.
    Returns {case: {kernel: result}}."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("add", "concat"):
            for i, (rows, samples, k) in enumerate(rows_list):
                joint, gru, greedy = odd_args(seed + i, rows, samples, k,
                                              dtype, mode, device, dims)
                case = f"{str(dtype)[6:]} {mode} rows={rows} k={k}"
                out[case] = {"decode_joint": check_joint(joint),
                             "decode_gru": check_gru("decode_gru", gru)}
                if greedy is not None:
                    out[case]["decode_gru_greedy"] = check_gru(
                        "decode_gru_greedy", greedy)
                    for go in (True, False):
                        out[case][f"decode_gru_greedy folded go={go}"] = (
                            check_gru("decode_gru_greedy", greedy, go))
    return out


def wide_cases(seed=0, device="cuda"):
    """`odd_cases` at `WIDE`'s widths and rows, then at `RING`'s, each
    under the same tolerances: {"wide" | "ring": {case: {kernel:
    result}}}, with each case's launch plans ({kernel: plan}) under
    "plans"."""
    out = {}
    for name, dims, rows_list in (("wide", WIDE, WIDE_ROWS),
                                  ("ring", RING, RING_ROWS)):
        out[name] = odd_cases(seed, device, dims, rows_list)
        out[name]["plans"] = {
            f"rows={rows}": plans(rows, dims) for rows, _, _ in rows_list}
    return out


def plans(rows, dims, mode="add", elem=2):
    """The launch plans at ``rows`` rows of ``dims``' widths:
    {"hidden", "logits", "gru"}."""
    K = dims["Hp"] * (2 if mode == "concat" else 1)
    return {"hidden": ds.dense_plan(rows, K, dims["H"], elem, True,
                                    mode == "concat"),
            "logits": ds.dense_plan(rows, dims["H"], dims["V"], elem, False),
            "gru": ds.gru_plan(rows, dims.get("Hg", dims["Hp"]))}


def _outputs(x):
    """A call's output tensors, flattened."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _outputs(part)]


@torch.inference_mode()
def check_deterministic(seed=0, device="cuda", dims=WIDE,
                        rows_list=WIDE_ROWS):
    """Each kernel called twice on the same arguments at ``dims``' widths
    (default `WIDE`), bf16 and fp32, add and concat: every output (and the
    joint's log-probs) equal bit for bit.  Returns the calls compared."""
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("add", "concat"):
            for i, (rows, samples, k) in enumerate(rows_list):
                joint, gru, greedy = odd_args(seed + i, rows, samples, k,
                                              dtype, mode, device, dims)
                runs = [("decode_joint", lambda lp: ds.decode_joint(
                            *joint[:10], k, lp)),
                        ("decode_gru", lambda lp: ds.decode_gru(*gru))]
                if greedy is not None:
                    runs.append(("decode_gru_greedy",
                                 lambda lp: ds.decode_gru_greedy(*greedy)))
                for name, fn in runs:
                    got = []
                    for _ in range(2):
                        lp = torch.empty((rows, dims["V"]), device=device)
                        got.append([*_outputs(fn(lp)), lp] if name ==
                                   "decode_joint" else _outputs(fn(lp)))
                    _sync(got[0][0])
                    if not all(torch.equal(_bits(a), _bits(b))
                               for a, b in zip(*got)):
                        raise AssertionError(f"{name} {mode} {dtype} rows="
                                             f"{rows}: two calls differ")
                    calls += 1
    return calls


def pdl_edges(args_joint, args_gru, name="decode_gru_greedy"):
    """A CUDA graph captured (`torch.cuda.graph`) around one `decode_joint`
    and one ``name`` call: (programmatic edges, edges) of the captured
    graph (`csrc/decode_step.cu` `decode_graph_edges`)."""
    return graph_edges([lambda: ds.decode_joint(*args_joint),
                        lambda: getattr(ds, name)(*args_gru)])


def graph_edges(calls):
    """(programmatic edges, edges) of a CUDA graph captured around
    ``calls`` (functions of no argument that launch, in order)."""
    import ctypes

    g = torch.cuda.CUDAGraph(keep_graph=True)
    for call in calls:  # built and warm, outside the capture
        call()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        for call in calls:
            call()
    lib, _ = ds._LIBS.get("decode_step") or ds._entries()
    out = (ctypes.c_longlong * 2)()
    code = lib.decode_graph_edges(ctypes.c_longlong(int(g.raw_cuda_graph())),
                                  out)
    if code:
        raise RuntimeError(f"decode_graph_edges: CUDA error {code}")
    return int(out[0]), int(out[1])


def step_edges(recs):
    """The folded steps' edges, captured from the recorded calls of
    ``recs`` (`record_states`; the count and last_tok of `fold_args`):
    {decoder: {"one": (programmatic, edges) of one step's launches, "two":
    of two steps', "gru_to_hidden": True where the one edge that joins
    the steps, from the GRU to the next step's hidden layer, is
    programmatic}}."""
    g, b = recs["greedy"].calls, recs["beam"].calls

    def mid(calls):
        return calls[len(calls) // 2]

    gru = fold_args("decode_gru_greedy", g["decode_gru_greedy"][-1], True)
    sel = fold_args("decode_beam_select", mid(b["decode_beam_select"]), True)
    bgru = mid(b["decode_gru"])
    steps = {
        "greedy": [lambda: ds.decode_joint(*mid(g["decode_joint"])),
                   lambda: ds.decode_gru_greedy(*gru)],
        "beam": [lambda: ds.decode_joint(*mid(b["decode_joint"])),
                 lambda: ds.decode_beam_select(*sel),
                 lambda: ds.decode_gru(*bgru[:9], src=bgru[9])]}
    out = {}
    for dec, step in steps.items():
        one, two = graph_edges(step), graph_edges(step + step)
        out[dec] = {"one": one, "two": two, "gru_to_hidden": (
            two[1] - 2 * one[1] == 1 and two[0] - 2 * one[0] == 1)}
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


def select_state(seed, B, device="cuda", K=None, L=None, V=None):
    """`decode_beam_select`'s arguments for a hand-built state at `ODD`'s
    L and V (or ``L``, ``V``), B beams, K (default min(B, V - 1)) labels a
    beam, one sample of each kind of
    `SELECT_SAMPLES`: random; every candidate tied; every beam of one
    hash, length and token row, so that their blanks (or their
    emissions) merge; beams at the emission cap and at u = L; the frame
    pointer at its bound; every beam at NEG; only beam 0 live (a fresh
    state); settled beams with -inf log-probs, so fewer candidates live
    than beams.  In the two duplicate samples the B picks are each
    beam's blank, or each beam's first label (one token): the merge
    keeps one of them.  Scores and log-probs are multiples of 1/8, so sums tie
    exactly."""
    L, V = L or ODD["L"], V or ODD["V"]
    K = K or min(B, V - 1)
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


# Widths (B, K) whose B (K + 1) candidates take each of the kernel's
# routes (`decode_step.select_plan`: one, two or four a lane in registers,
# then shared memory, up to `MAX_K` x (`MAX_K` + 1) = 4160), at an odd
# token length and a vocabulary past `MAX_K`.
SELECT_WIDTHS = ((1, 1), (4, 4), (5, 3), (6, 6), (12, 9), (16, 16), (64, 64))
SELECT_WIDTH_DIMS = dict(L=13, V=97)


def select_width_cases(seed=0, device="cuda", widths=SELECT_WIDTHS):
    """`check_select` on `select_state` at each (B, K) of ``widths`` and
    `SELECT_WIDTH_DIMS`, unfolded and folded with the loop's ``cond``
    true and false.  Returns {"B=.. K=.. go=..": result plus the
    plan}."""
    out = {}
    for B, K in widths:
        args = select_state(seed + B, B, device, K=K, **SELECT_WIDTH_DIMS)
        plan = ds.select_plan(args[0].numel(), B, K, SELECT_WIDTH_DIMS["L"])
        for go in (None, True, False):
            out[f"B={B} K={K} go={go}"] = {**check_select(args, go),
                                           "route": plan["route"],
                                           "slots": plan["slots"],
                                           "warps": plan["warps"]}
    return out


@torch.inference_mode()
def check_select_twice(seed=0, device="cuda", widths=SELECT_WIDTHS):
    """Two kernel calls of `decode_beam_select` on the same arguments at
    each of ``widths`` (folded, cond true), bit for bit.  Returns the
    calls compared."""
    calls = 0
    for B, K in widths:
        args = fold_args("decode_beam_select", select_state(
            seed + B, B, device, K=K, **SELECT_WIDTH_DIMS), True)
        _sync(args[2])
        a = ds.decode_beam_select(*args)
        b = ds.decode_beam_select(*args)
        _sync(args[2])
        _same_outputs(f"decode_beam_select B={B} K={K}: two calls", a, b,
                      (*SELECT_FIELDS, "count"))
        calls += 1
    return calls


def select_fold_cases(seed=0, device="cuda"):
    """`select_cases` folded, with the loop's ``cond`` true and false.
    Returns {"B=.. go=..": result}."""
    return {f"B={B} go={go}": check_select(select_state(seed + B, B, device),
                                           go)
            for B in SELECT_BEAMS for go in (True, False)}


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


def _session(model, feats, xn, max_length, beam, C, ops):
    """A streaming session (chunks of C; greedy where ``beam`` is 0)
    driven here on the drains' ``ops``, as `streaming.stream_step` and
    `stream_finish` drive it on the kernels: the final decoder state."""
    from warp_rnnt_tpu_torch.models.streaming import _NO_LIMIT

    enc = model.encoder
    N = feats.shape[0]
    enc_st = enc.stream_init(N)
    if beam:
        dec = beam_search.beam_state_init(model, N, beam, max_length,
                                          ops=ops)
        drain = beam_search.beam_drain
    else:
        dec = decoding.greedy_state_init(model, N, max_length, ops=ops)
        drain = decoding.greedy_drain
    xn = torch.as_tensor(xn, dtype=torch.int32, device=feats.device)
    for i in range(0, feats.shape[1], C):
        chunk = feats[:, i:i + C]
        enc_st, out, p0 = enc.stream(enc_st, chunk, _NO_LIMIT)
        bound = torch.minimum(xn, (p0 + chunk.shape[1]).clamp(min=0))
        dec = drain(model, dec, out, p0, bound, ops=ops)
    L = enc_st["m"]
    enc_st, out, p0 = enc.stream_finish(enc_st, L)
    return drain(model, dec, out, p0, torch.minimum(xn, L), ops=ops)


def _beam_session(model, feats, xn, max_length, beam, C, ops):
    """`_session` of beam ``beam``: (tokens, lengths, scores)."""
    return beam_search.beam_best(_session(model, feats, xn, max_length, beam,
                                          C, ops))


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


@torch.inference_mode()
def check_fold(model, feats, xn, max_length, beam, C):
    """The folded drains (`ops.decode_step`: the loop's mask and count in
    the step's kernels) through the device loop's graphs against the
    unfolded ones on the same kernels (`UNFOLDED`: the loop's own mask),
    run eagerly (`device_loop._plain`, the plain loop) and graphed:
    greedy, beam ``beam`` and a streaming session of each (chunks of C,
    `_session`), the whole final state bit for bit and the same trip
    counts; graphed on the card, one host read a drain.  Returns {case:
    {"iterations", "host_reads", "unfolded_host_reads": [eager,
    graphed]}}."""
    from warp_rnnt_tpu_torch.benchmarks.serving_cases import _counted

    enc = model.encode(feats)
    N = enc.shape[0]

    def runs(ops):
        return {
            "greedy": lambda: decoding.greedy_drain(
                model, decoding.greedy_state_init(model, N, max_length,
                                                  ops=ops),
                enc, 0, xn, ops=ops),
            f"beam {beam}": lambda: beam_search.beam_drain(
                model, beam_search.beam_state_init(model, N, beam,
                                                   max_length, ops=ops),
                enc, 0, xn, ops=ops),
            f"stream greedy C={C}": lambda: _session(
                model, feats, xn, max_length, 0, C, ops),
            f"stream beam {beam} C={C}": lambda: _session(
                model, feats, xn, max_length, beam, C, ops)}

    out = {}
    for case, fn in runs(ds).items():
        counter = "beam" if "beam" in case else "greedy"
        got, it, reads = _counted(counter, fn)
        drains = (math.ceil(feats.shape[1] / C) + 1 if "stream" in case
                  else 1)
        r = {"iterations": it, "host_reads": reads,
             "unfolded_host_reads": []}
        for plain in (True, False):
            want, it_u, reads_u = _counted(counter, runs(UNFOLDED)[case],
                                           plain)
            same = [torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want)]
            if not all(same) or it != it_u:
                how = "eager" if plain else "graphed"
                raise AssertionError(
                    f"{case}: folded != unfolded ({how}): fields equal"
                    f" {same}, {it} / {it_u} iterations")
            r["unfolded_host_reads"].append(reads_u)
        graphed = (reads, r["unfolded_host_reads"][1])
        if feats.is_cuda and graphed != (drains, drains):
            raise AssertionError(f"{case}: graphed host reads {reads}"
                                 f" folded, {r['unfolded_host_reads'][1]}"
                                 f" unfolded, for {drains} drains")
        out[case] = r
    return out


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


# The kernels under the loop's own mask (`device_loop`'s ``cond``, one
# ``torch.where`` a field and the count's add every step), as the drains
# ran them before the mask and count were folded into the step's kernels:
# any ``ops`` other than the module itself runs the loop unfolded
# (`decoding.folds`).
UNFOLDED = types.SimpleNamespace(
    __name__="unfolded", decode_joint=ds.decode_joint,
    decode_gru=ds.decode_gru, decode_gru_greedy=ds.decode_gru_greedy,
    decode_beam_select=ds.decode_beam_select)


BASELINE_SOURCE = "decode_step_baseline"


def _on_baseline(fn):
    """``fn`` launching the kernels of `csrc/decode_step_baseline.cu`."""
    def run(*args, **kwargs):
        with ds.using(BASELINE_SOURCE):
            return fn(*args, **kwargs)
    return run


# The step's first kernels (`csrc/decode_step_baseline.cu`: the dense,
# GRU and selection kernels as first written) behind the same wrappers:
# the yardstick the redesigns are timed against in turns.
BASELINE = types.SimpleNamespace(
    __name__="baseline", decode_joint=_on_baseline(ds.decode_joint),
    decode_gru=_on_baseline(ds.decode_gru),
    decode_gru_greedy=_on_baseline(ds.decode_gru_greedy),
    decode_beam_select=_on_baseline(ds.decode_beam_select))

# The folded step with the first selection kernel (one block a sample,
# block barriers, a plain launch) and this library's joint and GRU: beam's
# step timed in turns with the redesigned selection (`step_times`), the
# loop folded (`decoding.folds` reads ``folded``).
SELECT_BASELINE = types.SimpleNamespace(
    __name__="select_baseline", folded=True, decode_joint=ds.decode_joint,
    decode_gru=ds.decode_gru, decode_gru_greedy=ds.decode_gru_greedy,
    decode_beam_select=_on_baseline(ds.decode_beam_select))


def yardsticks(call_joint, call_gru, name):
    """What one PyTorch call per layer computes at the step's shapes, never
    called by the port: {"linear_hidden", "linear_logits": a bf16 (or the
    joint's dtype) `F.linear` of the rows' inputs by the layer's weight,
    "gru_cell": `torch.gru_cell` on the rows' embedded tokens}, each
    (fn, args)."""
    pred_out, w_pre, w_out = call_joint[3], call_joint[4], call_joint[6]
    rows, K = pred_out.shape[0], w_pre.shape[0]
    x = pred_out.new_zeros((rows, K), dtype=w_pre.dtype)
    x[:, :pred_out.shape[1]] = pred_out
    hid = x.new_zeros((rows, w_pre.shape[1]))
    if name == "decode_gru":
        token, h, _, _, embed, w_ih, w_hh, b_ih, b_hh = call_gru[:9]
    else:
        token, h, embed, w_ih, w_hh, b_ih, b_hh = (
            call_gru[0], call_gru[6], *call_gru[8:13])
    emb = F.embedding(token.long().clamp(min=0), embed)
    return {"linear_hidden": (F.linear, (x, w_pre.t())),
            "linear_logits": (F.linear, (hid, w_out.t())),
            "gru_cell": (torch.gru_cell, (emb, h, w_ih, w_hh, b_ih, b_hh))}


@torch.inference_mode()
def kernel_times(call_joint, name, call_gru, calls=16, call_select=None):
    """Device ms (CUDA graph, `timing.bench_graph`) of one recorded
    `decode_joint` call, one ``name`` GRU call and, when given, one
    `decode_beam_select` call: each with L2 warm (``warm``, as the decode
    loop finds its weights) and flushed (``ms``), the joint's and the
    GRU's in turns with `BASELINE`'s (baseline, kernel, kernel,
    baseline), beside the plain version's (flushed), and the
    `yardsticks` (warm, flushed): {kernel: {"ms", "warm_ms", "plain_ms",
    "baseline_ms", "baseline_warm_ms": [two each], "turns_ms",
    "turns_warm_ms": [two each]}, "yardsticks": {name: {"ms",
    "warm_ms"}}}."""
    out = {}
    kernels = [("decode_joint", ds.decode_joint, BASELINE.decode_joint,
                ds.decode_joint_plain, call_joint),
               ("decode_gru", getattr(ds, name), getattr(BASELINE, name),
                getattr(ds, f"{name}_plain"), call_gru)]
    if call_select is not None:
        kernels.append(("decode_beam_select", ds.decode_beam_select,
                        BASELINE.decode_beam_select,
                        ds.decode_beam_select_plain, call_select))
    for kernel, fn, base, plain, args in kernels:
        r = {"plain_ms": timing.bench_graph(plain, args, calls)}
        for key, flush in (("ms", 96 << 20), ("warm_ms", 0)):
            if base is None:
                r[key] = timing.bench_graph(fn, args, calls, flush)
                continue
            t = {"baseline": [], "kernel": []}
            for who in ("baseline", "kernel", "kernel", "baseline"):
                t[who].append(timing.bench_graph(
                    base if who == "baseline" else fn, args, calls, flush))
            r[key] = min(t["kernel"])
            r[f"turns_{key}"] = t["kernel"]
            r[f"baseline_{key}"] = t["baseline"]
        out[kernel] = r
    out["yardsticks"] = {
        y: {"ms": timing.bench_graph(fn, args, calls),
            "warm_ms": timing.bench_graph(fn, args, calls, 0)}
        for y, (fn, args) in yardsticks(call_joint, call_gru, name).items()}
    return out


@torch.inference_mode()
def step_times(model, feats, xn, max_length, beam,
               sides=(("baseline", BASELINE), ("kernels", ds))):
    """The graphed greedy and beam ``beam`` decodes' device us a step and
    each step kernel's us a step (`bench_decode.graph_numbers`, one
    replay's profile, and its kernels a step), and a whole drain's ms on
    the encoder's frames (its graphs captured by a drain before it; CUDA
    events, the host's reads of the loop's flag included), on the two
    ``sides`` ((name, ops); default `BASELINE` and the kernels, the loop
    folded), in turns (a, b, b, a): {decoder: {side: [{"step_us",
    "kernel_us": {name: us}, "kernels_a_step", "drain_ms"}, ...]}}."""
    from warp_rnnt_tpu_torch.benchmarks import bench_decode as bd

    enc = model.encode(feats)
    N = enc.shape[0]
    (a, ops_a), (b, ops_b) = sides
    out = {"greedy": {a: [], b: []}, "beam": {a: [], b: []}}

    def drains(ops):
        dec = decoding.greedy_state_init(model, N, max_length, ops=ops)
        st = beam_search.beam_state_init(model, N, beam, max_length, ops=ops)
        return {"greedy": lambda: decoding.greedy_drain(model, dec, enc, 0,
                                                        xn, ops=ops),
                "beam": lambda: beam_search.beam_drain(model, st, enc, 0, xn,
                                                       ops=ops)}

    for who, ops in ((a, ops_a), (b, ops_b), (b, ops_b), (a, ops_a)):
        for name, drain in drains(ops).items():
            drain()  # captures the drain's graphs
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            drain()
            end.record()
            end.synchronize()
            r = bd.graph_numbers(name)
            out[name][who].append({
                "step_us": r["graph_step_us"],
                "kernel_us": r["graph_step_kernel_us"],
                "kernels_a_step": r["graph_kernels_per_step"],
                "drain_ms": start.elapsed_time(end)})
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

