"""The compiled decode and the compiled streaming chunk on the card: their
checks and timers, shared by `chip_smoke.py` (`phase_compiled_decode`, at
`bench_decode`'s and `bench_streaming`'s widths) and the `cuda`-marked
tests of `tests/test_torch_compiled_decode_card.py` (small widths).  Each
check raises an AssertionError on a failure and returns what it measured.

  * `check_decode`: `decoding.compiled_greedy_decode` or
    `beam_search.compiled_beam_decode` against two references on the same
    inputs, bit for bit: the eager decode (`compiled_step._plain()`: the
    encoder and the state's init eager, the drain on its own while node)
    and the plain loop (`device_loop._plain()`: everything eager, a host
    read a round); on the capture's call, on a replay with other features
    and on a replay with every length 0 (cond false at entry).  In steady
    calls: one graph replay, one host read (`decoding.HOST_READS`) and no
    counted launch a call; the outer graph holds exactly one conditional
    node (`device_loop.body_kinds`), and the runtime calls a call as the
    profiler's host side sees them; the kernels a call launched on the
    card (`call_launches`), the loop's rounds as its kernel counted them
    on the card equal to those its trip count takes.
  * `check_chunk`: a streaming session (chunks of C, a ragged tail, the
    finish) compiled whole against `compiled_step._plain()` (as
    `compiled_serving_cases.check_stream_compiled`) and against
    `device_loop._plain()`, bit for bit on the whole state after every
    chunk; then a steady chunk's replays, host reads, runtime calls, the
    outer graph's node kinds and its launches (`call_launches`).
  * `check_bound`: a compiled step around a toy loop past its bound
    raises the eager loop's error after its replay; the next call, within
    the bound, replays the same graph and is right.
  * `check_held`: a compiled decode's loop survives `device_loop.clear()`
    and the loop cache's eviction: the replay after each equals the one
    before.
  * `check_update`: a compiled decode, then a compiled train step's
    replays (in-place updates), then the compiled decode again equals an
    eager decode on the updated weights and differs from the first.
  * `decode_times`, `chunk_times`: the compiled call and the eager one
    in turns, each call timed by CUDA events around it
    (`bench_decode.call_ms`: the host's path and read included), as JAX's
    ``timeit`` times a jitted decode; the compiled call's busy ms and idle
    share under the profiler, and its graph's replay alone (`replay_ms`).
"""

from __future__ import annotations

import collections
import contextlib

import torch

from warp_rnnt_tpu_torch.benchmarks.bench_decode import call_ms, median
from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile
from warp_rnnt_tpu_torch.models import (
    beam_search,
    decoding,
    stream_finish,
    stream_init,
    stream_step,
    streaming,
)
from warp_rnnt_tpu_torch.utils import compiled_step as cs
from warp_rnnt_tpu_torch.utils import device_loop as dl

STEADY = 3  # steady calls counted
# the runtime calls a call makes, by name, as the profiler's host side
# records them (the launches, the graph's replay, the copies, the read)
RUNTIME = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
           "cudaMemcpyAsync", "cudaMemsetAsync", "cudaEventSynchronize",
           "cudaStreamSynchronize", "cudaEventRecord")


def decoder(beam):
    """(the compiled decode fn(model, feats, xn, max_length), its
    counter's name, its graphs' key name) of greedy (``beam`` 0) or beam
    ``beam``."""
    if beam:
        return (lambda m, f, x, L: beam_search.compiled_beam_decode(
            m, f, x, L, beam_size=beam)), "beam", beam_search.COMPILED
    return decoding.compiled_greedy_decode, "greedy", decoding.COMPILED


def entry_of(name):
    """The most recently used compiled entry whose key starts with
    ``name``."""
    hits = [e for e in cs.entries() if isinstance(e.key[0], tuple)
            and e.key[0][0] == name]
    if not hits:
        raise AssertionError(f"no compiled graph of {name}")
    return hits[-1]


def _equal(tag, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{tag}: output {i} ({tuple(w.shape)},"
                                 f" {w.dtype}) differs")


def _clone(out):
    return tuple(t.clone() for t in out)


def runtime_calls(fn, calls=STEADY):
    """{runtime call: count a call} of ``fn()`` under the profiler's host
    side (`RUNTIME` names only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count / calls for ev in prof.key_averages()
            if ev.key in RUNTIME}


def steady(fn, name):
    """{"replays", "host_reads", "counted_launches", "iterations"} a call
    over `STEADY` calls of ``fn()`` after one: graph replays
    (`compiled_step.STATS`), host reads of decoder ``name``'s loop, the
    loop's counted launches, its trip count."""
    fn()
    replays, reads = cs.STATS["replays"], decoding.HOST_READS[name]
    launches = dl.LAUNCHES["loop_continue_kernel"]
    iterations = decoding.LOOP_ITERATIONS[name]
    for _ in range(STEADY):
        fn()
    torch.cuda.synchronize()
    return {"replays": (cs.STATS["replays"] - replays) / STEADY,
            "host_reads": (decoding.HOST_READS[name] - reads) / STEADY,
            "counted_launches": (dl.LAUNCHES["loop_continue_kernel"]
                                 - launches) / STEADY,
            "iterations": (decoding.LOOP_ITERATIONS[name]
                           - iterations) / STEADY}


def _hold_steady(tag, r):
    if r["replays"] != 1 or r["host_reads"] != 1 or r["counted_launches"]:
        raise AssertionError(f"{tag}: a call is not one replay and one host"
                             f" read: {r}")


def outer_kinds(entry):
    """The node kinds of a compiled entry's graph (child graphs walked, a
    conditional node's body not): exactly one conditional node."""
    kinds = dl.body_kinds(entry.graph)
    if kinds.get("conditional") != 1:
        raise AssertionError(f"the compiled graph's nodes: {kinds}")
    return kinds


def call_launches(entry):
    """{kernel name (mangled): launches} of the last replay of compiled
    ``entry``, read from the graphs it ran: each kernel node of its graph
    outside the while node once, and each of a loop's round (the body's
    child graph) times the rounds that loop ran in the replay, which
    ``loop_continue_kernel`` counted on the card and the replay's host
    read brought back (`device_loop._Entry.rounds`); the kernel itself
    once a round."""
    out = collections.Counter(dl.kernel_names(entry.graph.raw_cuda_graph()))
    for loop in entry.loops:
        for name, n in loop.round_kernels().items():
            out[name] += n * loop.rounds
        out["loop_continue_kernel"] += loop.rounds
    return dict(out)


def _hold_rounds(tag, entry, iterations):
    """The loop's rounds counted on the card are those of its trip count
    at its unroll (every round but the last runs cond true throughout)."""
    for loop in entry.loops:
        want = max(1, -(-int(iterations) // loop.unroll))
        if loop.rounds != want:
            raise AssertionError(f"{tag}: {loop.rounds} rounds counted on"
                                 f" the card, {want} for {iterations}"
                                 f" iterations at unroll {loop.unroll}")


@torch.inference_mode()
def check_decode(model, feats, xn, max_length, beam):
    """`check_decode` of the module docstring.  Returns {"steady",
    "launches", "rounds", "runtime_calls", "kinds", "capture_ms",
    "pool_mib"}."""
    fn, name, key = decoder(beam)
    tag = f"compiled {name} decode"
    other = torch.roll(feats, 1, dims=0)
    zero = torch.zeros_like(xn)
    for i, (f, x) in enumerate(((feats, xn), (other, xn), (feats, zero))):
        got = _clone(fn(model, f, x, max_length))
        with cs._plain():
            eager = fn(model, f, x, max_length)
        with dl._plain():
            plain = fn(model, f, x, max_length)
        _equal(f"{tag} call {i} against eager", got, eager)
        _equal(f"{tag} call {i} against the plain loop", got, plain)
    entry = entry_of(key)
    r = steady(lambda: fn(model, feats, xn, max_length), name)
    _hold_steady(tag, r)
    _hold_rounds(tag, entry, r["iterations"])
    launches = call_launches(entry)
    rounds = [loop.rounds for loop in entry.loops]
    return {"steady": r, "launches": launches, "rounds": rounds,
            "runtime_calls": runtime_calls(
                lambda: fn(model, feats, xn, max_length)),
            "kinds": outer_kinds(entry), "capture_ms": entry.capture_ms,
            "pool_mib": entry.pool_bytes / 2 ** 20}


def _session(model, feats, xn, max_length, beam, C):
    """[the state after each chunk, then the finish's results]."""
    st = stream_init(model, feats.shape[0], max_length, beam_size=beam)
    out = []
    for i in range(0, feats.shape[1], C):
        st = stream_step(model, st, feats[:, i:i + C], xn=xn)
        out.append(tuple(t.clone() for t in streaming._leaves(st)))
    out.append(tuple(t.clone() for t in stream_finish(model, st, xn=xn)[:-1]))
    return out


@torch.inference_mode()
def check_chunk(model, feats, xn, max_length, beam, C):
    """`check_chunk` of the module docstring.  Returns {"chunks",
    "steady", "launches", "runtime_calls", "kinds"}."""
    name = "beam" if beam else "greedy"
    tag = f"compiled chunk {name} C={C}"
    got = _session(model, feats, xn, max_length, beam, C)
    for ref, ctx in (("eager", cs._plain), ("the plain loop", dl._plain)):
        with ctx():
            want = _session(model, feats, xn, max_length, beam, C)
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(f"{tag} chunk {i} against {ref}", g, w)
    box = [stream_init(model, feats.shape[0], max_length, beam_size=beam)]
    chunk = feats[:, :C].contiguous()

    def one():
        box[0] = stream_step(model, box[0], chunk, xn=xn)

    r = steady(one, name)
    _hold_steady(tag, r)
    launches = call_launches(streaming.LAST_GRAPH["step"])
    return {"chunks": len(got) - 1, "steady": r, "launches": launches,
            "runtime_calls": runtime_calls(one),
            "kinds": outer_kinds(streaming.LAST_GRAPH["step"])}


def _toy_step(max_iterations, frames=False):
    """A compiled step around `device_loop_cases`' toy loop of bound
    ``max_iterations`` (``frames``: its folded toy, whose cond the card
    takes): step(i, acc, calls, lim) or step(i, acc, lim) -> the final
    state."""
    from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc

    cond, body = dlc._frames_toy() if frames else dlc._toy()
    key = ("compiled toy", frames, max_iterations, dl.UNROLL)

    def fn(*args):
        return dl.while_loop(cond, body, args[:-1], args[-1:],
                             max_iterations=max_iterations, key=key,
                             folded=frames)[0]

    return cs.compiled_step(fn, key=key)


def check_bound(device="cuda", frames=False):
    """`check_bound` of the module docstring: the toy (``frames``: the
    folded toy on the card's cond) at a bound of 9, captured on lengths
    within it, then replayed on the ragged lengths (10 trips), then within
    it again.  Returns {"message", "next_call_iterations"}."""
    from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc

    state = dlc._toy_state(dlc.LIMITS["ragged"], device)
    if frames:
        state = state[:2]
    within = torch.tensor([0, 3, 7, 9], dtype=torch.int32, device=device)
    past = torch.tensor(dlc.LIMITS["ragged"], dtype=torch.int32,
                        device=device)
    step = _toy_step(9, frames)
    with dl._plain():
        want = _clone(step(*state, within))
    _equal("compiled bound, the capture's call", step(*state, within), want)
    msgs = []
    for plain in (False, True):
        with dl._plain() if plain else contextlib.nullcontext():
            replays = cs.STATS["replays"]
            try:
                step(*state, past)
            except RuntimeError as e:
                msgs.append(str(e))
            else:
                raise AssertionError("compiled loop past its bound: no raise")
            if not plain and cs.STATS["replays"] - replays != 1:
                raise AssertionError("compiled bound: not after one replay")
    if "past its bound of 9" not in msgs[0] or msgs[0] != msgs[1]:
        raise AssertionError(f"compiled bound: {msgs}")
    got = step(*state, within)
    _equal("compiled bound, the next call", got, want)
    return {"message": msgs[0], "next_call_iterations": int(got[0].max())}


@torch.inference_mode()
def check_held(model, feats, xn, max_length):
    """`check_held` of the module docstring (greedy).  Returns the loop
    entries dropped by the eviction."""
    from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc

    fn = decoding.compiled_greedy_decode
    want = _clone(fn(model, feats, xn, max_length))
    dl.clear()
    _equal("compiled decode after device_loop.clear()",
           fn(model, feats, xn, max_length), want)
    saved, dl.CACHE_SIZE = dl.CACHE_SIZE, 1
    try:
        decoding.greedy_decode(model, feats, xn, max_length)  # a loop cached
        dlc.check_toy("ragged", 4, feats.device.type)  # evicts it
        evicted = len(dl.entries())
    finally:
        dl.CACHE_SIZE = saved
    _equal("compiled decode after the loop cache's eviction",
           fn(model, feats, xn, max_length), want)
    return evicted


def check_update(dims, seed=0, device="cuda"):
    """`check_update` of the module docstring at `train_cases` ``dims``
    (beam 2 decodes of the batch's features).  Returns the largest change
    of a beam score."""
    from warp_rnnt_tpu_torch.benchmarks import compiled_train_cases as ctc
    from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

    model, batch = tc.carried(seed, dims, device=device)
    feats, xn, L = batch[0], batch[2], dims["U"]

    def decode():
        with torch.inference_mode():
            return beam_search.compiled_beam_decode(model, feats, xn, L,
                                                    beam_size=2)

    before = _clone(decode())
    step = ctc._train_step(model, "gather", True, True)
    for _ in range(2):  # the capture's call, then a replay
        step(batch)
    got = _clone(decode())
    with cs._plain(), torch.inference_mode():
        want = beam_search.beam_decode(model, feats, xn, L, beam_size=2)
    _equal("compiled decode after a compiled train step", got, want)
    change = float((got[2] - before[2]).abs().max())
    if change == 0:
        raise AssertionError("compiled decode: the scores did not move"
                             " after two train steps")
    return change


def summary(ms):
    """{"median", "min", "max"} of readings ``ms``."""
    return {"median": median(ms), "min": min(ms), "max": max(ms)}


def replay_ms(entry, replays=20):
    """Device ms of one replay of a compiled ``entry``'s graph alone:
    ``replays`` back to back, CUDA events around them, no host read
    between (its busy time and the gaps inside the graph; the profiler
    misses records inside a conditional node's body now and then)."""
    entry.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        entry.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def _turns(run, entry, calls):
    """``run()`` timed by `call_ms` in turns, eager (`compiled_step._plain`),
    compiled, compiled, eager, ``calls`` calls each after one; the
    compiled call's profile, and its graph's replay alone (`replay_ms`,
    ``entry()`` the compiled entry).  Returns {"compiled": [ms], "eager":
    [ms], "busy_ms", "idle_share", "kernels", "replay_ms"}."""
    out = {"compiled": [], "eager": []}
    for compiled in (False, True, True, False):
        with contextlib.nullcontext() if compiled else cs._plain():
            run()
            out["compiled" if compiled else "eager"] += call_ms(run, calls)
    prof = device_profile(run, 5, cpu=False)
    return {**out, "busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"],
            "kernels": prof["kernels_per_call"],
            "replay_ms": replay_ms(entry())}


@torch.inference_mode()
def decode_times(model, feats, xn, max_length, beam, calls=10):
    """The compiled decode (greedy, or beam ``beam``) and the eager one
    (`_turns`)."""
    fn, _, key = decoder(beam)
    return _turns(lambda: fn(model, feats, xn, max_length),
                  lambda: entry_of(key), calls)


@torch.inference_mode()
def chunk_times(model, chunk, max_length, beam, calls=10):
    """A steady session's compiled chunk (token buffers full, the same
    chunk again and again) and the eager one (`_turns`)."""
    N, C = chunk.shape[:2]
    box = [stream_init(model, N, max_length, beam_size=beam)]
    for _ in range(max_length // C + 4):
        box[0] = stream_step(model, box[0], chunk)

    def one():
        box[0] = stream_step(model, box[0], chunk)

    return _turns(one, lambda: streaming.LAST_GRAPH["step"], calls)
