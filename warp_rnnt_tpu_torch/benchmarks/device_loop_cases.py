"""The device loop's while node on the card (`utils/device_loop.py`,
`csrc/device_loop.cu`): its cases and checks, shared by `chip_smoke.py`
(phase 15) and the `cuda`-marked tests of
`tests/test_torch_device_loop_card.py`.  Each check raises AssertionError
on a failure and returns what it measured.

  * `check_toy`: a toy loop (`LIMITS`: ragged trip counts, all equal,
    none, one sample far past the rest; a body that changes a field even
    where every sample is done) through the while node against the eager
    loop on the card (`device_loop._plain`), the whole state bit for bit,
    the trip count max(limits) (JAX's: `tests/test_torch_device_loop.py`
    holds the eager loop against ``lax.while_loop``), one host read.
  * `check_false_at_entry`: a loop whose cond is false at entry runs one
    masked round: the state bit for bit, count 0, one read.
  * `check_bound`: a loop past its bound raises the eager loop's
    RuntimeError after one launch (the while node stops at the bound).
  * `check_continue`: ``loop_continue_kernel`` against its plain version,
    the eager loop's stop rule (`device_loop._continues`), on a probe loop
    whose body counts every step it runs (so the state shows how many
    rounds the node ran): steps, count and cond equal the rule's, and the
    rounds the kernel counted on the card (`_Entry.rounds`) the steps
    over the unroll, at unroll 1, 4 and 16, the bound above, at and below
    the trip count.
  * `check_frames_toy`: a folded toy whose cond is a `device_loop.AnyLess`
    (so the card takes it: the round's last step writes the static
    buffers, ``loop_continue_kernel`` computes the cond) against the eager
    loop, at each of `UNROLLS`; `check_bound` runs it past its bound too.
  * `check_drains`: greedy, beam and streaming sessions on the step's
    kernels through the while node against `_plain()`, the whole final
    state bit for bit, the same trip counts, one host read a drain, at
    each of ``unrolls``.
  * `body_report`: a drain's body, its node kinds (all of `BODY_KINDS`)
    and its round's edges as built, against the captured round's;
    `round_report`: the round's tail by the graph's nodes
    (`decode_turns.round_tail`), whether the card takes the cond, and
    whether a conditional body takes a programmatic edge into
    ``loop_continue_kernel`` (`device_loop.edge_probe`).
  * `continue_times`, `unroll_times`: the node's cost a round, and the
    drains' launch ms at unroll 1, 4 and 16 beside the same rounds
    replayed back to back from the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.decode_step_cases import _bits, _session
from warp_rnnt_tpu_torch.benchmarks.decode_turns import (
    fit_us,
    launch_ms,
    recorded_loops,
)
from warp_rnnt_tpu_torch.models import beam_search, decoding
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop as dl

MOD = 1000003
# toy trip counts: ragged, all equal, none, one sample far past the rest
# (`tests/test_torch_device_loop.py`'s)
LIMITS = {"ragged": [0, 3, 7, 10], "equal": [5, 5, 5, 5], "none": [0, 0, 0, 0],
          "one": [1, 0, 12, 2]}
UNROLLS = (1, 4, 16)
# the probe's trip counts and bounds (None: the trip count itself)
PROBE_TRIPS = (0, 1, 5, 16, 17, 40)
PROBE_BOUNDS = (None, 1, 3, 100)
ROUNDS = (100, 1000)  # the probe's rounds timed at unroll 1


def _toy():
    def cond(state, consts):
        return (state[0] < consts[0]).any()

    def body(state, consts):
        i, acc, calls = state
        on = i < consts[0]
        return (torch.where(on, i + 1, i), (acc * 3 + i + 1) % MOD, calls + 1)

    return cond, body


def _toy_state(lim, device):
    gen = torch.Generator().manual_seed(len(lim))
    return (torch.zeros(len(lim), dtype=torch.int32, device=device),
            torch.randint(0, MOD, (len(lim),), generator=gen,
                          dtype=torch.int32).to(device),
            torch.zeros((), dtype=torch.int32, device=device))


def _frames_toy():
    """The toy as a folded loop whose cond is an `AnyLess` (the card takes
    it): state (i, acc), consts (lim,); the body masks and counts its own
    step and writes ``into`` where given."""
    cond = dl.AnyLess(0, 0)

    def body(state, consts, count, into=None):
        i, acc = state
        go = cond(state, consts)
        on = go & (i < consts[0])
        out = into or (None,) * 3
        return (torch.where(on, i + 1, i, out=out[0]),
                torch.where(go, (acc * 3 + i + 1) % MOD, acc, out=out[1])), \
            torch.add(count, go, out=out[2])

    return cond, body


def check_frames_toy(case, unroll, device="cuda"):
    """`LIMITS[case]` as `_frames_toy` at ``unroll``: the while node (the
    card's cond) against the eager loop, bit for bit, JAX's trip count,
    one host read; the round has no tail where unroll > 1 (no copy)."""
    lim = torch.tensor(LIMITS[case], dtype=torch.int32, device=device)
    state = _toy_state(LIMITS[case], device)[:2]
    with dl.unrolled(unroll):
        got, want = _graphed_and_plain(*_frames_toy(), state, (lim,),
                                       max(LIMITS[case]), "frames toy",
                                       folded=True)
    r = _hold(f"frames toy {case} unroll {unroll}", got, want)
    if r["iterations"] != max(LIMITS[case]):
        raise AssertionError(f"frames toy {case}: {r['iterations']}"
                             " iterations")
    entry = got[1].graph
    if entry is not None:
        if entry.card_cond is None:
            raise AssertionError("frames toy: the card does not take cond")
        copies = entry.kinds.get("memcpy", 0) + entry.kinds.get("memset", 0)
        r["copies"] = copies
        if unroll > 1 and copies:
            raise AssertionError(f"frames toy unroll {unroll}: {copies}"
                                 " copies in the round")
    return r


def _graphed_and_plain(cond, body, state, consts, max_iterations, key,
                       folded=False):
    # off the card the while node's plain version (`_host_node`) stands
    # in for it where the card would take the cond
    with dl._host_node():
        got = dl.while_loop(cond, body, state, consts,
                            max_iterations=max_iterations, key=key,
                            folded=folded)
    with dl._plain():
        want = dl.while_loop(cond, body, state, consts,
                             max_iterations=max_iterations, key=key,
                             folded=folded)
    return got, want


def _hold(tag, got, want):
    (g, gs), (w, ws) = got, want
    same = [torch.equal(a, b) for a, b in zip(g, w)]
    if not all(same) or gs.iterations != ws.iterations:
        raise AssertionError(f"{tag}: while node != eager loop, fields equal"
                             f" {same}, {gs.iterations} / {ws.iterations}"
                             " iterations")
    if gs.host_reads != 1:
        raise AssertionError(f"{tag}: {gs.host_reads} host reads")
    return {"iterations": gs.iterations, "host_reads": gs.host_reads,
            "plain_host_reads": ws.host_reads}


def check_toy(case, unroll, device="cuda"):
    """`LIMITS[case]` at ``unroll`` (module docstring)."""
    lim = torch.tensor(LIMITS[case], dtype=torch.int32, device=device)
    state = _toy_state(LIMITS[case], device)
    saved = tuple(x.clone() for x in state)
    with dl.unrolled(unroll):
        r = _hold(f"toy {case} unroll {unroll}", *_graphed_and_plain(
            *_toy(), state, (lim,), max(LIMITS[case]), "toy"))
    if r["iterations"] != max(LIMITS[case]):
        raise AssertionError(f"toy {case}: {r['iterations']} iterations")
    if not all(torch.equal(a, b) for a, b in zip(state, saved)):
        raise AssertionError(f"toy {case}: the caller's state was written")
    return r


def check_false_at_entry(device="cuda"):
    """A toy whose cond is false at entry, at unroll 16: one masked round,
    the state as it came in, count 0."""
    lim = torch.zeros(4, dtype=torch.int32, device=device)
    state = _toy_state([0] * 4, device)
    got, want = _graphed_and_plain(*_toy(), state, (lim,), 4, "toy")
    r = _hold("cond false at entry", got, want)
    if r["iterations"] or not all(
            torch.equal(a, b) for a, b in zip(got[0], state)):
        raise AssertionError("cond false at entry: the state changed or"
                             f" counted {r['iterations']}")
    return r


def check_bound(device="cuda", frames=False):
    """The ragged toy (10 trips; ``frames``: `_frames_toy`, the card's
    cond) against a bound of 9 at unroll 1 and 4: both loops raise the
    same RuntimeError; the while node's raise comes after one launch.
    Returns {unroll: the message}."""
    lim = torch.tensor(LIMITS["ragged"], dtype=torch.int32, device=device)
    state = _toy_state(LIMITS["ragged"], device)
    toy = "frames" if frames else "toy"
    cond, body = _frames_toy() if frames else _toy()
    st = state[:2] if frames else state
    out = {}
    for unroll in (1, 4):
        msgs = []
        for plain in (False, True):
            before = dl.LAUNCHES["loop_continue_kernel"]
            try:
                with dl.unrolled(unroll), (
                        dl._plain() if plain else contextlib.nullcontext()):
                    dl.while_loop(cond, body, st, (lim,), max_iterations=9,
                                  key=toy, folded=toy == "frames")
            except RuntimeError as e:
                msgs.append(str(e))
            else:
                raise AssertionError(f"bound 9, unroll {unroll}: no raise")
            launched = dl.LAUNCHES["loop_continue_kernel"] - before
            if not plain and launched != 1:
                raise AssertionError("bound: not one launch")
        if "past its bound of 9" not in msgs[0] or msgs[0] != msgs[1]:
            raise AssertionError(f"bound, {toy} unroll {unroll}: {msgs}")
        out[unroll] = msgs
    return out


def _probe():
    """A folded loop whose body counts every step it runs (``calls``),
    masked or not, so the final state shows the rounds the loop ran."""
    def cond(state, consts):
        return state[0] < consts[0]

    def body(state, consts, count):
        i, calls = state
        go = i < consts[0]
        return (torch.where(go, i + 1, i), calls + 1), count + go

    return cond, body


def _continue_plain(trips, bound, unroll):
    """(steps run, count, cond) of the probe under the eager loop's stop
    rule (`device_loop._continues`)."""
    steps = 0
    while True:
        steps += unroll
        count = min(steps, trips)
        go = int(count < trips)
        if not dl._continues(go, count, bound):
            return steps, count, go


def check_continue(device="cuda"):
    """``loop_continue_kernel`` against `_continues` (module docstring).
    Returns {"cases", "max_abs_err", "launches"} (the while launches
    made)."""
    cond, body = _probe()
    err, cases, launches = 0, 0, dl.LAUNCHES["loop_continue_kernel"]
    for unroll in UNROLLS:
        for trips in PROBE_TRIPS:
            k = torch.tensor(trips, dtype=torch.int32, device=device)
            zero = torch.zeros((), dtype=torch.int32, device=device)
            with dl.unrolled(unroll):
                _, stats = dl.while_loop(cond, body, (zero, zero), (k,),
                                         max_iterations=trips, key="probe",
                                         folded=True)
            entry = stats.graph
            for bound in PROBE_BOUNDS:
                bound = trips if bound is None else bound
                entry.load((zero, zero), (k,), bound)
                entry.launch()
                go, count = entry.read()
                steps = int(entry.state[1])
                want = _continue_plain(trips, bound, unroll)
                want += (want[0] // unroll,)  # the rounds run
                got = (steps, count, go, entry.rounds)
                err = max(err, *(abs(a - b) for a, b in zip(got, want)))
                cases += 1
                if got != want:
                    raise AssertionError(
                        f"loop_continue: unroll {unroll}, trips {trips},"
                        f" bound {bound}: (steps, count, cond, rounds)"
                        f" {got} on the card, {want} by the rule")
    return {"cases": cases, "max_abs_err": float(err),
            "launches": dl.LAUNCHES["loop_continue_kernel"] - launches}


def continue_times(device="cuda", repeats=3):
    """The while node's cost a round: the probe at unroll 1 (one masked
    step, the round's tail, ``loop_continue_kernel``) run for each of
    `ROUNDS` rounds, device ms of each launch alone; a round's ms is the
    difference over the rounds' difference.  Beside it the plain loop's
    (`_plain()`: a host read a round), CUDA events around the loop, and
    the kernel's bound: 12 bytes read, two comparisons.  Returns {"ms",
    "plain_ms", "bound_ms", "bound_by", "runs"}."""
    cond, body = _probe()
    zero = torch.zeros((), dtype=torch.int32, device=device)
    hbm, fp32, _ = timing.card_rates()
    runs = {"while": {}, "plain": {}}
    for rounds in ROUNDS:
        k = torch.tensor(rounds, dtype=torch.int32, device=device)
        with dl.unrolled(1):
            _, stats = dl.while_loop(cond, body, (zero, zero), (k,),
                                     max_iterations=rounds, key="probe",
                                     folded=True)
            ms, it = launch_ms(stats.graph, (zero, zero), (k,), rounds,
                               repeats)
            if it != rounds:
                raise AssertionError(f"probe: {it} of {rounds} rounds")
            runs["while"][rounds] = min(ms)
            with dl._plain():
                runs["plain"][rounds] = min(_events_ms(
                    lambda: dl.while_loop(cond, body, (zero, zero), (k,),
                                          max_iterations=rounds,
                                          key="probe", folded=True))
                    for _ in range(repeats))
    lo, hi = ROUNDS
    per = {who: (r[hi] - r[lo]) / (hi - lo) for who, r in runs.items()}
    bytes_s, ops_s = 12 / hbm, 2 / fp32
    return {"ms": per["while"], "plain_ms": per["plain"],
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "runs": runs}


def continue_bound(n):
    """(bound ms, by) of ``loop_continue_kernel`` where it takes the cond
    of ``n`` frame pointers and bounds: 2n + 3 ints read (t, the bounds,
    the count, the loop's bound, the rounds), 3 written; n comparisons."""
    hbm, fp32, _ = timing.card_rates()
    bytes_s, ops_s = (4 * (2 * n + 3) + 12) / hbm, n / fp32
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def round_fit(times):
    """A round's µs outside its steps (`decode_turns.fit_us`) from one
    decoder's `unroll_times` entry, the steps' µs from the host-launched
    replays at unroll 16."""
    a, b = times[4], times[16]
    return fit_us({4: a["launch_ms"], 16: b["launch_ms"]},
                  {4: a["rounds"], 16: b["rounds"]},
                  min(b["replays_ms"]) * 1e3 / (b["rounds"] * 16))


def _events_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _drains(model, feats, xn, max_length, beam, C, N):
    enc = model.encode(feats)
    return {
        "greedy": (1, lambda: decoding.greedy_drain(
            model, decoding.greedy_state_init(model, N, max_length), enc, 0,
            xn)),
        f"beam {beam}": (1, lambda: beam_search.beam_drain(
            model, beam_search.beam_state_init(model, N, beam, max_length),
            enc, 0, xn)),
        f"stream greedy C={C}": (
            math.ceil(feats.shape[1] / C) + 1,
            lambda: _session(model, feats, xn, max_length, 0, C, ds)),
        f"stream beam {beam} C={C}": (
            math.ceil(feats.shape[1] / C) + 1,
            lambda: _session(model, feats, xn, max_length, beam, C, ds))}


@torch.inference_mode()
def check_drains(model, feats, xn, max_length, beam, C, unrolls=(None,)):
    """Greedy, beam ``beam`` and a streaming session of each (chunks of
    C) on the step's kernels: through the while node against `_plain()`,
    the whole final state bit for bit, the same trip count, one host read
    a drain; at each of ``unrolls`` (None: `device_loop.UNROLL`).  Returns
    {case (with " unroll u" past None): {"iterations", "host_reads",
    "drains", "plain_host_reads"}}."""
    out = {}
    for unroll in unrolls:
        if unroll is None:
            out.update(_check_drains(model, feats, xn, max_length, beam, C))
            continue
        with dl.unrolled(unroll):
            r = _check_drains(model, feats, xn, max_length, beam, C)
        out.update({f"{k} unroll {unroll}": v for k, v in r.items()})
    return out


def _check_drains(model, feats, xn, max_length, beam, C):
    from warp_rnnt_tpu_torch.benchmarks.serving_cases import _counted

    out = {}
    for case, (drains, fn) in _drains(model, feats, xn, max_length, beam, C,
                                      feats.shape[0]).items():
        counter = "beam" if "beam" in case else "greedy"
        launches = dl.LAUNCHES["loop_continue_kernel"]
        got, it, reads = _counted(counter, fn)
        launched = dl.LAUNCHES["loop_continue_kernel"] - launches
        want, it_p, reads_p = _counted(counter, fn, plain=True)
        same = [torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want)]
        if not all(same) or it != it_p:
            raise AssertionError(f"{case}: while node != plain loop, fields"
                                 f" equal {same}, {it} / {it_p} iterations")
        if reads != drains or launched != drains:
            raise AssertionError(f"{case}: {reads} host reads and"
                                 f" {launched} launches for {drains} drains")
        out[case] = {"iterations": it, "host_reads": reads, "drains": drains,
                     "plain_host_reads": reads_p}
    return out


def body_report(name="greedy"):
    """Decoder ``name``'s last while node: {"kinds": the body's node
    kinds, "edges": (programmatic, all) edges of its round as built,
    "captured_edges": the same of the captured round
    (`decode_step.cu` `decode_graph_edges`)}.  Raises where a kind is
    not one a conditional body takes or the build lost an edge."""
    entry = decoding.LAST_GRAPH[name]
    lib, _ = ds._LIBS.get("decode_step") or ds._entries()
    out = (ctypes.c_longlong * 2)()
    code = lib.decode_graph_edges(
        ctypes.c_longlong(int(entry.graph.raw_cuda_graph())), out)
    if code:
        raise RuntimeError(f"decode_graph_edges: CUDA error {code}")
    captured = (int(out[0]), int(out[1]))
    if not set(entry.kinds) <= dl.BODY_KINDS:
        raise AssertionError(f"{name}: body kinds {entry.kinds}")
    if tuple(entry.edges) != captured:
        raise AssertionError(f"{name}: the body's round has edges"
                             f" {entry.edges}, the captured round {captured}")
    return {"kinds": entry.kinds, "edges": list(entry.edges),
            "captured_edges": list(captured)}


def round_report(name="greedy"):
    """Decoder ``name``'s last while node: its round's tail
    (`decode_turns.round_tail`: the round graph's node kinds, its kernel
    nodes that are not the step's, its memcpy and memset nodes, and the
    launches after the round's last step, ``loop_continue_kernel``
    included), "card_cond" (the card takes the loop's cond), "unroll",
    the body's (programmatic, all) edges, and "edge_probe"
    (`device_loop.edge_probe`).  Where the card takes the cond and the
    unroll exceeds 1, raises unless the tail is that one launch."""
    from warp_rnnt_tpu_torch.benchmarks.decode_turns import round_tail

    entry = decoding.LAST_GRAPH[name]
    tail = round_tail(entry)
    if entry.card_cond is not None and entry.unroll > 1 and (
            tail["tail_launches"] != 1):
        raise AssertionError(f"{name}: the round's tail is {tail}")
    return {**tail, "card_cond": entry.card_cond is not None,
            "unroll": entry.unroll, "edges": list(entry.edges),
            "edge_probe": dl.edge_probe()}


def replays_ms(entry, state, consts, max_iterations, rounds, repeats):
    """Device ms of ``rounds`` replays of ``entry``'s round graph launched
    back to back from the host (torch's own exec, no read between them),
    each run from ``state`` and ``consts`` copied in before it: the while
    node's work without the node.  Returns (the ms, the trip count after
    the last run)."""
    entry.replay()  # torch instantiates its exec at the first replay
    out = []
    for _ in range(repeats):
        entry.load(state, consts, max_iterations)
        out.append(_events_ms(lambda: [entry.replay() for _ in range(rounds)]))
    return out, int(entry.count)


@torch.inference_mode()
def unroll_times(model, feats, xn, max_length, beam, repeats=3):
    """{decoder: {unroll: {"launch_ms": [..], "replays_ms": [..],
    "iterations", "rounds", "host_reads"}}}: the greedy and beam drains'
    while-node launch alone (`decode_turns.launch_ms`, from the drain's
    own inputs) at each of `UNROLLS`, and beside it the same rounds as
    replays of the round's graph launched back to back from the host
    (`replays_ms`), which must end at the same trip count."""
    N = feats.shape[0]
    drains = _drains(model, feats, xn, max_length, beam, 16, N)
    out = {}
    for name, counter in (("greedy", "greedy"), (f"beam {beam}", "beam")):
        out[name] = {}
        for unroll in UNROLLS:
            with dl.unrolled(unroll), recorded_loops() as seen:
                reads = decoding.HOST_READS[counter]
                drains[name][1]()
                reads = decoding.HOST_READS[counter] - reads
            ms, it = launch_ms(*seen[-1], repeats)
            rounds = max(1, math.ceil(it / unroll))
            replays, it_r = replays_ms(*seen[-1], rounds, repeats)
            if it_r != it:
                raise AssertionError(f"{name} unroll {unroll}: {rounds}"
                                     f" replays end at {it_r} iterations,"
                                     f" the while node at {it}")
            out[name][unroll] = {"launch_ms": ms, "replays_ms": replays,
                                 "iterations": it, "rounds": rounds,
                                 "host_reads": reads}
    return out
