"""Decoding throughput on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_decode.py`).

Batched greedy and beam-search decoding of whole utterances at the JAX
benchmark's shapes, with its arguments and JSON keys.  As JAX times its
jitted decoders, the decode runs compiled by default
(`decoding.compiled_greedy_decode`, `beam_search.compiled_beam_decode`:
one CUDA graph a shape, one replay and one host read a call), and the
eager one (`greedy_decode`, `beam_decode`) is timed beside it
(``name_eager_ms``; ``--eager``: the eager one alone).  A decode's ms is
the median of `CALLS` calls, each timed by CUDA events around it (the
host's path and its read included; the device idle before each call), as
JAX's ``timeit(greedy, feats, iters=10)``; ``name_ms_range`` holds the
least and the largest reading.  Beside it, per decode:
the loop iterations (JAX's trip count, `decoding.LOOP_ITERATIONS`), the
host reads of the loop's flag (`decoding.HOST_READS`), the peak device
memory, and under the profiler (`profile_loss.device_profile`, device
activity only, PROFILED decodes) the kernels, the device's busy ms and its
idle share.  The decode loop (`utils.device_loop`) runs as one CUDA graph
while node whose body is a round of ``unroll`` masked steps: the round
graph's capture ms (the while node's build included) (warm-up included), its
private pool's MiB, its kernels a step (one replay under the profiler over
``unroll``) and its device us a step (REPLAYS replays back to back on CUDA
events, over REPLAYS x unroll), the step's own kernels a step and any
library kernel they replaced still in the step (`step_kernels`), and the
kernels a replay launches outside the step's (`round_kernels`).
``plain`` runs the loop eagerly on the card instead (`device_loop._plain`,
the plain version, nothing compiled); its graph keys are then None.

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_decode [N] [T] [V]
           [beam] [--unroll U ...] [--eager | --plain]
Prints one JSON line for each unroll.  Needs a CUDA device; the CLI turns
TF32 off in cuBLAS and cuDNN, as `chip_smoke.py` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode, init_model
from warp_rnnt_tpu_torch.models.beam_search import compiled_beam_decode
from warp_rnnt_tpu_torch.models.decoding import (
    HOST_READS,
    LAST_GRAPH,
    LOOP_ITERATIONS,
    compiled_greedy_decode,
)
from warp_rnnt_tpu_torch.utils import device_loop

CALLS = 10  # decodes timed, each by CUDA events around it
PROFILED = 1  # decodes under the profiler
TOP = 6  # kernels listed by device time a decode
REPLAYS = 20  # graph replays timed for the device us a step
GRAPH_KEYS = ("capture_ms", "graph_pool_mb", "graph_kernels_per_step",
              "graph_step_us", "graph_step_kernels", "graph_step_kernel_us",
              "graph_step_replaced", "graph_round_kernels")


def loop_mode(plain=False, unroll=None):
    """The decode loop's mode for a benchmark: eager on the card when
    ``plain``, else graphs of ``unroll`` steps (default
    `device_loop.UNROLL`)."""
    stack = contextlib.ExitStack()
    if plain:
        stack.enter_context(device_loop._plain())
    if unroll is not None:
        stack.enter_context(device_loop.unrolled(unroll))
    return stack


# The step's kernels (`ops/decode_step.py`) by their names in a trace,
# and the library kernels they took the place of (lower case): the
# joint's and the GRU's, then beam's selection's (torch's gathers and
# index_select, argmax rounds, and the cats and stacks of the candidates
# and the top-k).
STEP_KERNELS = ("decode_joint", "decode_gru", "decode_beam_select")
REPLACED = ("gemm", "gru_cell", "softmax", "tanh", "gather", "indexselect",
            "argmax", "catarray")
# Launches of replaced kernels that a round makes outside its steps:
# `device_loop._status` stacks the loop's flag and count once a round.
ROUND_TAIL = {"catarray": 1}


def step_kernels(rows, unroll, us=None):
    """From a graph replay's profile ``rows`` [(ms, launches, name)] of
    ``unroll`` steps (one round): ({name: launches a step} of the step's
    kernels, [names of kernels the step's kernels replaced that still
    run, past the round's own `ROUND_TAIL`]); ``us``, a dict, receives
    each step kernel's device us a step."""
    ours, left = {}, []
    tail = dict(ROUND_TAIL)
    for ms, n, key in rows:
        if any(k in key for k in STEP_KERNELS):
            name = key[:100]
            ours[name] = ours.get(name, 0) + n / unroll
            if us is not None:
                us[name] = us.get(name, 0.0) + ms * 1e3 / unroll
            continue
        hit = next((k for k in REPLACED if k in key.lower()), None)
        if hit is None:
            continue
        spare = min(n, tail.get(hit, 0))
        tail[hit] = tail.get(hit, 0) - spare
        if n > spare:
            left.append(key[:100])
    return ours, left


def round_kernels(rows):
    """{name: launches} of a graph replay's profile ``rows`` [(ms,
    launches, name)] outside the step's kernels: the loop's own (with the
    loop folded into the step's kernels, only the round's tail: the last
    ``cond``, the state's copies back, the status)."""
    out = {}
    for _, n, key in rows:
        if not any(k in key for k in STEP_KERNELS):
            out[key[:100]] = out.get(key[:100], 0) + n
    return out


def graph_numbers(name):
    """{capture_ms, graph_pool_mb, graph_kernels_per_step,
    graph_step_us, graph_step_kernels, graph_step_kernel_us,
    graph_step_replaced, graph_round_kernels} of the graph of decoder
    ``name``'s last drain (`step_kernels`, `round_kernels`: launches a
    replay; the kernels' us under the profiler)."""
    entry = LAST_GRAPH[name]
    prof = device_profile(entry.replay, 1, cpu=False)
    us = {}
    ours, left = step_kernels(prof["rows"], entry.unroll, us)
    entry.replay()  # the state is final: every step is masked
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        entry.replay()
    end.record()
    end.synchronize()
    return {"capture_ms": entry.capture_ms,
            "graph_pool_mb": entry.pool_bytes / 2**20,
            "graph_kernels_per_step": prof["kernels_per_call"] / entry.unroll,
            "graph_step_us": start.elapsed_time(end) * 1e3
            / (REPLAYS * entry.unroll),
            "graph_step_kernels": ours, "graph_step_kernel_us": us,
            "graph_step_replaced": left,
            "graph_round_kernels": round_kernels(prof["rows"])}


def step_work(model, samples, rows, k=None, L=0, emitting=None):
    """{kernel: (bytes, operation seconds on this card)}: what each of the
    step's kernels must move and compute for ``rows`` hypotheses of
    ``samples`` samples (greedy: rows = samples, ``k`` None, a token
    buffer of ``L``; beam: top ``k`` labels, a token buffer of ``L`` a
    beam).  `decode_joint` reads the
    samples' frames, the rows' predictor outputs and the joint's weights
    and biases in its compute dtype once, and writes the best label or the
    blank log-prob and top-k; two operations a multiply-add of its two
    products, at the bf16 tensor-core rate or the fp32 rate.  `decode_gru`
    reads the GRU's fp32 parameters, each row's embedding, state and
    output, and writes the new state and output (greedy: also its integer
    fields and the token buffer, read and written; beam: the row map);
    two operations a multiply-add of its two (rows, H') x (H', 3H')
    products at the fp32 rate, over the ``emitting`` rows (all rows when
    None): a row that does not emit is only copied.  Beam's
    `decode_beam_select` reads the state (t, frame bounds; each beam's
    score, u, nexp, waiting, hash and token row) and the joint's blank
    log-prob and top-k once, and writes the new state and each row's
    emit, token and parent; its operations, at the fp32 rate: two adds a
    candidate, a comparison a candidate in each of the B argmax rounds,
    and three comparisons a pair of beams in the merge."""
    hbm, fp32, bf16 = timing.card_rates()
    j, p = model.joint, model.predictor
    cd_bytes = torch.empty((), dtype=j.compute_dtype).element_size()
    F_in, H = j.pre.in_features, j.pre.out_features
    V, Hp = j.out.out_features, p.hidden
    F = model.encoder.out_ln.normalized_shape[0]
    n_joint = sum(t.numel() for t in j.parameters())
    out_bytes = 4 * rows if k is None else rows * (4 + 8 * k)
    joint_bytes = (4 * samples * (F + 1) + 4 * rows * p.hidden
                   + cd_bytes * n_joint + out_bytes)
    joint_rate = bf16 if j.compute_dtype == torch.bfloat16 else fp32
    joint_ops = 2 * rows * (F_in * H + H * V) / joint_rate
    n_gru = sum(t.numel() for t in (p.weight_ih, p.weight_hh, p.bias_ih,
                                    p.bias_hn)) + 2 * Hp
    gru_bytes = 4 * n_gru + 4 * rows * (5 * Hp + 1) + rows
    if k is None:  # t, u, emitted_here, frame_bound in, three out; tokens
        gru_bytes += 4 * rows * 7 + 8 * rows * L
    gru_ops = 2 * (rows if emitting is None else emitting) * 6 * Hp * Hp / fp32
    work = {"decode_joint": (joint_bytes, joint_ops),
            "decode_gru": (gru_bytes, gru_ops)}
    if k is not None:
        gru_bytes += 4 * rows  # the row map
        B = rows // samples
        # in: t, frame bound; score, u, nexp, waiting, hash, token row;
        # lp_blank, top-k values and ids.  Out: t; the same beam fields;
        # emit, token and parent
        select_in = 8 * samples + rows * (25 + 4 * L + 8 * k)
        select_out = 4 * samples + rows * (30 + 4 * L)
        cands = rows * (k + 1)
        select_ops = (2 * cands + B * cands + 3 * B * rows) / fp32
        work.update(decode_gru=(gru_bytes, gru_ops),
                    decode_beam_select=(select_in + select_out, select_ops))
    return work


def _bound(nbytes, ops_s):
    bytes_s = nbytes / timing.card_rates()[0]
    return (max(bytes_s, ops_s) * 1e6,
            "bytes" if bytes_s >= ops_s else "operations")


def kernel_bounds(model, samples, rows, k=None, L=0, emitting=None):
    """{kernel: (us, "bytes" or "operations")}: the least time each of
    the step's kernels could take on this card (`step_work`)."""
    return {name: _bound(*w) for name, w in step_work(
        model, samples, rows, k, L, emitting).items()}


def step_bound(model, samples, rows, k=None, L=0):
    """(us, "bytes" or "operations"): the least time one decode step of
    ``rows`` hypotheses could take on this card: the step kernels' bytes
    (`step_work`) over the memory's rate, or their operations, whichever
    is longer.  The rest of a round (the loop's masks where the step does
    not fold them in, the round's tail) moves a few KB."""
    work = step_work(model, samples, rows, k, L).values()
    return _bound(sum(b for b, _ in work), sum(o for _, o in work))


def call_ms(fn, calls=CALLS):
    """[ms] of ``calls`` calls of ``fn()``, CUDA events around each, read
    after it: the host's path and its reads included, the device idle
    before each call (a decode ends by reading its loop's status)."""
    out = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def median(xs):
    s = sorted(xs)
    return (s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2


def decode_numbers(name, fn, feats, N, plain=False, eager=None):
    """{name_ms (the median of `call_ms`), name_ms_range [least, largest],
    name_utts_per_s, name_iterations, name_host_reads, name_peak_mb,
    name_kernels, name_busy_ms, name_idle_share, name_top: the TOP
    kernels by device ms a decode, [ms, launches, name], and
    name_capture_ms, name_graph_pool_mb, name_graph_kernels_per_step,
    name_graph_step_us (None when ``plain``)} of ``fn(feats)``, a decoder
    whose loop counts in ``LOOP_ITERATIONS[name]`` and
    ``HOST_READS[name]``; with ``eager``, a second decoder, its
    name_eager_ms and name_eager_ms_range, timed in turns with ``fn``
    (eager, fn, fn, eager, `CALLS` / 2 calls each)."""
    device_loop.clear()  # so the warm-up captures, and its capture ms counts
    fn(feats)  # warm up (cuBLAS and cuDNN handles, allocator, the graphs)
    torch.cuda.synchronize()
    LOOP_ITERATIONS[name] = HOST_READS[name] = 0
    torch.cuda.reset_peak_memory_stats()
    fn(feats)
    torch.cuda.synchronize()
    iterations, reads = LOOP_ITERATIONS[name], HOST_READS[name]
    peak = torch.cuda.max_memory_allocated()
    if eager is None:
        times = {"": call_ms(lambda: fn(feats))}
    else:
        eager(feats)
        times = {"": [], "_eager": []}
        for tag, f in (("_eager", eager), ("", fn), ("", fn),
                       ("_eager", eager)):
            times[tag] += call_ms(lambda: f(feats), CALLS // 2)
    ms = median(times[""])
    prof = device_profile(lambda: fn(feats), PROFILED, cpu=False)
    graph = (dict.fromkeys(GRAPH_KEYS) if plain else graph_numbers(name))
    return {**{f"{name}{tag}_ms": median(t) for tag, t in times.items()},
            **{f"{name}{tag}_ms_range": [min(t), max(t)]
               for tag, t in times.items()},
            f"{name}_utts_per_s": N / (ms / 1e3),
            f"{name}_iterations": iterations,
            f"{name}_host_reads": reads,
            f"{name}_peak_mb": peak / 2**20,
            f"{name}_kernels": prof["kernels_per_call"],
            f"{name}_busy_ms": prof["busy_ms"],
            f"{name}_idle_share": prof["idle_share"],
            f"{name}_top": [[ms, n, key[:60]]
                            for ms, n, key in prof["rows"][:TOP]],
            **{f"{name}_{k}": v for k, v in graph.items()}}


def bench_decode(N=32, T=400, V=1024, beam=4, feat_dim=80, hidden=512,
                 max_length=100, model=None, unroll=None, plain=False,
                 eager=False):
    """The decoders' numbers as a dict: the JAX benchmark's keys (N, T, V,
    hidden, beam, greedy_ms, greedy_utts_per_s, beam_ms, beam_utts_per_s),
    then the loop's (unroll, plain, compiled), per decoder
    `decode_numbers`' others and `step_bound` (name_step_bound_us,
    name_step_bound_by), and device.  The model is `init_model`'s seed 0
    (as the JAX benchmark's key 0) unless ``model`` is given; the features
    are normal from seed 1, every frame valid.  ``unroll`` and ``plain``
    as `loop_mode`; the decoders compiled unless ``eager`` or ``plain``,
    the eager ones beside them."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode needs a CUDA device")
    if model is None:
        model = init_model(0, vocab_size=V, feat_dim=feat_dim, N=N, T=T, U=8,
                           device="cuda", encoder_hidden=hidden,
                           predictor_hidden=hidden, joint_hidden=hidden)[0]
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn((N, T, feat_dim), generator=gen).to("cuda")
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")

    def greedy(f):
        return greedy_decode(model, f, xn, max_length=max_length)

    def beam_fn(f):
        return beam_decode(model, f, xn, max_length=max_length,
                           beam_size=beam)

    def compiled_greedy(f):
        return compiled_greedy_decode(model, f, xn, max_length)

    def compiled_beam(f):
        return compiled_beam_decode(model, f, xn, max_length,
                                    beam_size=beam)

    compiled = not (eager or plain)
    r = {"N": N, "T": T, "V": V, "hidden": hidden, "beam": beam,
         "max_length": max_length}
    with loop_mode(plain, unroll):
        r.update(unroll=device_loop.UNROLL, plain=plain, compiled=compiled)
        if compiled:
            g = decode_numbers("greedy", compiled_greedy, feats, N,
                               eager=greedy)
            b = decode_numbers("beam", compiled_beam, feats, N,
                               eager=beam_fn)
        else:
            g = decode_numbers("greedy", greedy, feats, N, plain)
            b = decode_numbers("beam", beam_fn, feats, N, plain)
    r.update({k: g[k] for k in ("greedy_ms", "greedy_utts_per_s")})
    r.update({k: b[k] for k in ("beam_ms", "beam_utts_per_s")})
    r.update(g)
    r.update(b)
    K = min(beam, V - 1)
    for name, rows, k in (("greedy", N, None), ("beam", N * beam, K)):
        r[f"{name}_step_bound_us"], r[f"{name}_step_bound_by"] = step_bound(
            model, N, rows, k, max_length)
    r["device"] = torch.cuda.get_device_name(0)
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cfg", nargs="*", type=int,
                        help="N T V beam (default 32 400 1024 4)")
    parser.add_argument("--unroll", nargs="+", type=int, default=[None])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true")
    mode.add_argument("--plain", action="store_true")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for unroll in args.unroll:
        print(json.dumps(bench_decode(*(args.cfg or [32, 400, 1024, 4]),
                                      unroll=unroll, plain=args.plain,
                                      eager=args.eager)),
              flush=True)


if __name__ == "__main__":
    main()
