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
  * "decode_ms": `bench_decode.decode_numbers`' two-point marginal of a
    whole decode (encoder included).
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


@torch.inference_mode()
def readings(repeats):
    """{decoder: {"drain_ms": [..], "host_reads": [..], "launch_ms": [..]
    or None, "step_us": [..], "kernels_a_step": [..], "kernel_us": {..},
    "round_kernels": {..}, "decode_ms": [..]}}."""
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
        "greedy": lambda f: greedy_decode(model, f, xn, MAX_LENGTH),
        "beam": lambda f: beam_decode(model, f, xn, MAX_LENGTH,
                                      beam_size=BEAM)}
    out = {}
    for name, drain in drains.items():
        r = out[name] = {"drain_ms": [], "host_reads": [], "step_us": [],
                         "kernels_a_step": [], "decode_ms": []}
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
        r["kernel_us"] = g["graph_step_kernel_us"]
        r["round_kernels"] = g.get("graph_round_kernels")
        for _ in range(repeats):
            r["decode_ms"].append(bd.decode_numbers(
                name, decodes[name], feats, N)[f"{name}_ms"])
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
