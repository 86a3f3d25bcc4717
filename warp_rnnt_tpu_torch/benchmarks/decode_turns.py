"""The decoders' graphed step and drains of one tree on a CUDA device, for
comparing two trees in turns.

    python -m warp_rnnt_tpu_torch.benchmarks.decode_turns [--tag x]
        [--repeats R]

At `bench_decode`'s width (N=32, T=400, V=1024, hidden 512, beam 4; the
model `init_model`'s seed 0, the features normal from seed 1, every
frame valid), for greedy and beam 4 on the step's kernels (the drains'
default ``ops``), prints one JSON line a decoder with the tag, the card
and R readings (default 3) of:
  * "drain_ms": a drain of the encoder's frames from a fresh state, its
    graphs captured by a drain before it (CUDA events around it, the
    host's reads of the loop's flag included), and "host_reads", the
    drain's reads of the loop's flag (`decoding.HOST_READS`);
  * "launch_ms": where the tree's loop is one while node (its entry has
    `launch`), that launch alone, from the drain's own inputs copied in
    before it (`launch_ms`); None in an older tree;
  * "step_us", "kernels_a_step", "kernel_us", "round_kernels": the
    drain's last graph (`bench_decode.graph_numbers`: device us a step
    over replays of a finished state, a replay's profile over its
    unroll; `round_kernels` where the tree has it);
  * "tail": the nodes of the drain's round graph that are not the step's
    kernels (`round_tail`: the round's tail, counted from the graph's
    kernel and memcpy nodes), and "tail_launches", those plus
    ``loop_continue_kernel`` (one a round in the while node's body);
  * "round_us": a round's cost outside its steps (its tail and the while
    node), fitted from the while launch alone at unroll 4 and 16
    (`round_fit`), with those launches' readings;
  * "decode_ms": `CALLS` whole decodes (encoder included) on the public
    eager entry (`greedy_decode`, `beam_decode`), each timed by CUDA
    events around it (`call_ms`: the host's path and its read included),
    and "compiled_decode_ms" the same of the compiled decode
    (`decoding.compiled_greedy_decode`, `beam_search.compiled_beam_decode`;
    None in a tree without it), in turns: eager, compiled, compiled,
    eager, `CALLS` / 2 calls each.
Only entry points that older trees have are read, so a copy of this file
placed in an older tree's `benchmarks/` and run there (that tree's root
as the working directory) times that tree: parent, change, change,
parent, one process each.  Needs a CUDA device; TF32 off in cuBLAS and
cuDNN.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

N, T, V, BEAM, F, HIDDEN, MAX_LENGTH = 32, 400, 1024, 4, 80, 512, 100
CALLS = 10  # decodes timed a reading


def call_ms(fn, calls):
    """[ms] of ``calls`` calls of ``fn()``, CUDA events around each, read
    after it (a decode ends by reading its loop's status, so the device is
    idle before each call)."""
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


def decode_readings(eager, compiled):
    """{"decode_ms": [..], "compiled_decode_ms": [..] or None} of the
    decoders ``eager`` and ``compiled`` (None where the tree has none),
    each called once first, in turns (module docstring)."""
    out = {"decode_ms": [], "compiled_decode_ms": None}
    order = (eager,) if compiled is None else (eager, compiled, compiled,
                                               eager)
    calls = CALLS if compiled is None else CALLS // 2
    for fn in {id(f): f for f in order}.values():
        fn()
    if compiled is not None:
        out["compiled_decode_ms"] = []
    for fn in order:
        key = "decode_ms" if fn is eager else "compiled_decode_ms"
        out[key] += call_ms(fn, calls)
    return out


@contextlib.contextmanager
def recorded_loops():
    """Within the block, each drain's device loop is recorded: yields a
    list that receives (the loop's `LoopStats.graph`, its state, its
    consts, its max_iterations) a loop.  The drains reach the loop
    through `models.decoding`'s ``while_loop``, wrapped here."""
    from warp_rnnt_tpu_torch.models import decoding

    seen, real = [], decoding.while_loop

    def spy(cond, body, state, consts=(), **kw):
        out = real(cond, body, state, consts, **kw)
        seen.append((out[1].graph, tuple(state), tuple(consts),
                     kw["max_iterations"]))
        return out

    decoding.while_loop = spy
    try:
        yield seen
    finally:
        decoding.while_loop = real


def launch_ms(entry, state, consts, max_iterations, repeats):
    """Device ms of ``repeats`` whole loops of a while-node ``entry``
    (`_Entry.launch`, CUDA events around the launch alone), each from
    ``state`` and ``consts`` copied in before it, and the trip count of
    the last; None where the entry has no while node."""
    if not hasattr(entry, "launch"):
        return None, None
    out = []
    for _ in range(repeats):
        entry.load(state, consts, max_iterations)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        entry.launch()
        end.record()
        go, iterations = entry.read()
        out.append(start.elapsed_time(end))
    return out, iterations


def round_tail(entry):
    """{"kinds": the round graph's node kinds, "other_kernels": {name:
    nodes} of its kernel nodes that are not the step's, "copies": its
    memcpy and memset nodes, "tail_launches": those plus the while
    body's ``loop_continue_kernel``} of a while-node ``entry``."""
    from warp_rnnt_tpu_torch.benchmarks.bench_decode import STEP_KERNELS
    from warp_rnnt_tpu_torch.utils import device_loop as dl

    kinds = dl.body_kinds(entry.graph)
    other = {k: n for k, n in entry.round_kernels().items()
             if not any(s in k for s in STEP_KERNELS)}
    copies = kinds.get("memcpy", 0) + kinds.get("memset", 0)
    return {"kinds": kinds, "other_kernels": other, "copies": copies,
            "tail_launches": sum(other.values()) + copies + 1}


def fit_us(ms, rounds, step_us):
    """A round's µs outside its steps: the while launch alone at unroll 4
    and 16 (``ms`` {unroll: [ms]}, the fastest of each), less the steps
    each ran (rounds x unroll, the masked surplus of the last round
    included) at ``step_us`` a step, over the difference in rounds."""
    steps = {u: rounds[u] * u for u in (4, 16)}
    return (((min(ms[4]) - min(ms[16])) * 1e3
             - (steps[4] - steps[16]) * step_us) / (rounds[4] - rounds[16]))


def round_fit(drain, step_us, repeats):
    """`fit_us` of ``drain``'s while launch (`launch_ms`, ``repeats``
    readings at unroll 4 and 16).  Returns {"us", "launch_ms": {unroll:
    [..]}, "rounds": {unroll: n}}."""
    from warp_rnnt_tpu_torch.utils import device_loop as dl

    ms, rounds = {}, {}
    for unroll in (4, 16):
        with dl.unrolled(unroll), recorded_loops() as seen:
            drain()
        ms[unroll], it = launch_ms(*seen[-1], repeats)
        rounds[unroll] = max(1, -(-it // unroll))
    return {"us": fit_us(ms, rounds, step_us), "launch_ms": ms,
            "rounds": rounds}


@torch.inference_mode()
def readings(repeats):
    """{decoder: {"drain_ms": [..], "host_reads": [..], "launch_ms": [..]
    or None, "step_us": [..], "kernels_a_step": [..], "kernel_us": {..},
    "round_kernels": {..}, "decode_ms": [..], "compiled_decode_ms": [..]
    or None}}."""
    from warp_rnnt_tpu_torch.benchmarks import bench_decode as bd
    from warp_rnnt_tpu_torch.models import (
        beam_decode,
        beam_search,
        decoding,
        greedy_decode,
        init_model,
    )

    model = init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=8,
                       device="cuda", encoder_hidden=HIDDEN,
                       predictor_hidden=HIDDEN, joint_hidden=HIDDEN)[0]
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn((N, T, F), generator=gen).to("cuda")
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    enc = model.encode(feats)
    drains = {
        "greedy": lambda: decoding.greedy_drain(
            model, decoding.greedy_state_init(model, N, MAX_LENGTH), enc, 0,
            xn),
        "beam": lambda: beam_search.beam_drain(
            model, beam_search.beam_state_init(model, N, BEAM, MAX_LENGTH),
            enc, 0, xn)}
    decodes = {
        "greedy": lambda: greedy_decode(model, feats, xn, MAX_LENGTH),
        "beam": lambda: beam_decode(model, feats, xn, MAX_LENGTH,
                                    beam_size=BEAM)}
    greedy_c = getattr(decoding, "compiled_greedy_decode", None)
    beam_c = getattr(beam_search, "compiled_beam_decode", None)
    compiled = {
        "greedy": greedy_c and (lambda: greedy_c(model, feats, xn,
                                                 MAX_LENGTH)),
        "beam": beam_c and (lambda: beam_c(model, feats, xn, MAX_LENGTH,
                                           beam_size=BEAM))}
    out = {}
    for name, drain in drains.items():
        r = out[name] = {"drain_ms": [], "host_reads": [], "step_us": [],
                         "kernels_a_step": []}
        with recorded_loops() as seen:
            drain()  # captures the drain's graphs
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reads = decoding.HOST_READS[name]
            start.record()
            drain()
            end.record()
            end.synchronize()
            r["drain_ms"].append(start.elapsed_time(end))
            r["host_reads"].append(decoding.HOST_READS[name] - reads)
            g = bd.graph_numbers(name)
            r["step_us"].append(g["graph_step_us"])
            r["kernels_a_step"].append(g["graph_kernels_per_step"])
        r["launch_ms"] = launch_ms(*seen[-1], repeats)[0]
        if r["launch_ms"] is not None:
            r["tail"] = round_tail(seen[-1][0])
            r["tail_launches"] = r["tail"]["tail_launches"]
            r["round_us"] = round_fit(drain, min(r["step_us"]), repeats)
        r["kernel_us"] = g["graph_step_kernel_us"]
        r["round_kernels"] = g.get("graph_round_kernels")
        r.update(decode_readings(decodes[name], compiled[name]))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_turns needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from warp_rnnt_tpu_torch.utils.profiling import card_line

    card = card_line()
    for name, r in readings(args.repeats).items():
        print(json.dumps({"tag": args.tag, "decoder": name, "card": card,
                          **r}), flush=True)


if __name__ == "__main__":
    main()
