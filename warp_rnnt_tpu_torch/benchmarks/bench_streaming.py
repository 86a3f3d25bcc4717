"""Streaming-session latency on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_streaming.py`).

The per-chunk latency of `models.stream_step` (the chunked encoder and the
incremental greedy or beam decode, `models/streaming.py`): with the
encoder's 4-frame lookahead it bounds an online user's lag.  As JAX times
its jitted `stream_step`, the chunk runs compiled by default: one CUDA
graph a shape (`streaming.chunk_step`: the encoder's step and the drain's
while node), one replay and one host read a chunk; ``--eager`` runs the
chunk eagerly (`compiled_step._plain`: the drain on its own while node),
``--plain`` the loop too.  The chunk
chain feeds the same chunk again and again through the session state, so
each step needs the last one's state (the token buffer fills up to
max_length, after which steps only consume frames: the steady serving
regime); the chunk is an argument of the step, not a constant of it.  The
ms is the two-point marginal of `timing.bench_grad_chain` on CUDA events.
Beside it, per chunk: the decoder's loop iterations (JAX's trip count)
and host reads of the loop's flag, the graph replays (the chunk's, or
where it runs eagerly the drain's while launch, one a drain), the peak
device memory, the chunk graphs' capture ms and pool MiB by shape, and
under the
profiler (`profile_loss.device_profile`, device activity only, PROFILED
chunks) the kernels, the device's busy ms and its idle share; and the
decode loop's graph, as `bench_decode.graph_numbers` (None when
``plain``).

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_streaming [N] [C] [V]
           [beam] [--unroll U ...] [--eager | --plain]
Prints one JSON line for each unroll.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.bench_decode import (
    GRAPH_KEYS,
    graph_numbers,
    loop_mode,
)
from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile
from warp_rnnt_tpu_torch.models import init_model, stream_init, stream_step
from warp_rnnt_tpu_torch.models.decoding import HOST_READS, LOOP_ITERATIONS
from warp_rnnt_tpu_torch.utils import compiled_step, device_loop

PROFILED = 10  # chunks under the profiler


def chunk_graphs():
    """{"step N=.. C=..": {capture_ms, pool_mib}} of the cached graphs of
    the whole chunk (`streaming.chunk_step`; "finish" for
    `stream_finish`'s, " beam" for a beam session's, " xn" where ``xn`` is
    given), by N and the chunk's frames."""
    out = {}
    for e in compiled_step.entries():
        key = e.key[0]
        if isinstance(key, tuple) and key[0] == "streaming.chunk_step":
            spec, beam, finish, with_xn = key[3:7]
            N = spec[-9 if beam else -7][0][0]  # the frame pointer t (N,)
            C = "" if finish else f" C={e.args[1].shape[1]}"
            tag = f"{'finish' if finish else 'step'} N={N}{C}"
            out[tag + " beam" * beam + " xn" * with_xn] = {
                "capture_ms": e.capture_ms, "pool_mib": e.pool_bytes / 2**20}
    return out


def bench_streaming(N=8, C=16, V=1024, beam=0, feat_dim=80, hidden=512,
                    max_length=100, model=None, unroll=None, plain=False,
                    eager=False):
    """The session's numbers as a dict: the JAX benchmark's keys (N,
    chunk_frames, V, hidden, beam, chunk_ms, frames_per_s,
    ms_per_frame_per_stream), then unroll, plain, compiled,
    iterations_per_chunk, host_reads_per_chunk, graph_replays_per_chunk
    ({chunk, drain}), chunk_graphs (`chunk_graphs`), peak_mb,
    kernels_per_chunk, busy_ms, idle_share, `bench_decode.graph_numbers`'
    keys and device.  The model is `init_model`'s seed 0 unless ``model``
    is given; the chunk is normal from seed 1.  ``unroll`` and ``plain`` as
    `bench_decode.loop_mode`; ``eager`` or ``plain`` runs the chunk
    eagerly (`compiled_step._plain`)."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_streaming needs a CUDA device")
    if model is None:
        model = init_model(0, vocab_size=V, feat_dim=feat_dim, N=N, T=C, U=8,
                           device="cuda", encoder_hidden=hidden,
                           predictor_hidden=hidden, joint_hidden=hidden)[0]
    gen = torch.Generator().manual_seed(1)
    chunk = torch.randn((N, C, feat_dim), generator=gen).to("cuda")
    dec_key = "dec_beam" if beam else "dec"
    loop = "beam" if beam else "greedy"

    def step(s):
        return s[dec_key][1], stream_step(model, s, chunk)

    compiled = not (plain or eager)
    with loop_mode(plain, unroll) as stack:
        if not compiled:
            stack.enter_context(compiled_step._plain())
        unroll = device_loop.UNROLL
        device_loop.clear()  # the chain's warm-up captures
        state = stream_init(model, N, max_length=max_length, beam_size=beam)
        ms = timing.bench_grad_chain(step, state, iters=30)

        # the steady regime: a session whose token buffers are full
        state = stream_init(model, N, max_length=max_length, beam_size=beam)
        for _ in range(max_length // C + 4):
            state = stream_step(model, state, chunk)
        torch.cuda.synchronize()
        LOOP_ITERATIONS[loop] = HOST_READS[loop] = 0
        replays = compiled_step.STATS["replays"]
        torch.cuda.reset_peak_memory_stats()
        state = stream_step(model, state, chunk)
        torch.cuda.synchronize()
        iterations, reads = LOOP_ITERATIONS[loop], HOST_READS[loop]
        replays = compiled_step.STATS["replays"] - replays
        peak = torch.cuda.max_memory_allocated()
        box = [state]

        def one():
            box[0] = stream_step(model, box[0], chunk)

        prof = device_profile(one, PROFILED, cpu=False)
        graph = (dict.fromkeys(GRAPH_KEYS) if plain
                 else graph_numbers(loop))
    return {
        "N": N, "chunk_frames": C, "V": V, "hidden": hidden, "beam": beam,
        "chunk_ms": ms,
        "frames_per_s": N * C / (ms / 1e3),
        "ms_per_frame_per_stream": ms / C,
        "unroll": unroll, "plain": plain, "compiled": compiled,
        "iterations_per_chunk": iterations,
        "host_reads_per_chunk": reads,
        # compiled: the chunk's one replay holds the drain's while node;
        # eager: a drain is one launch of its while node and one host read
        "graph_replays_per_chunk": {
            "chunk": replays, "drain": 0 if plain or compiled else reads},
        "chunk_graphs": chunk_graphs(),
        "peak_mb": peak / 2**20,
        "kernels_per_chunk": prof["kernels_per_call"],
        "busy_ms": prof["busy_ms"],
        "idle_share": prof["idle_share"],
        **graph,
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cfg", nargs="*", type=int,
                        help="N C V beam (default 8 16 1024 0)")
    parser.add_argument("--unroll", nargs="+", type=int, default=[None])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true")
    mode.add_argument("--plain", action="store_true")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for unroll in args.unroll:
        print(json.dumps(bench_streaming(*args.cfg, unroll=unroll,
                                         plain=args.plain, eager=args.eager)),
              flush=True)


if __name__ == "__main__":
    main()
