"""Decoding throughput on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_decode.py`).

Batched greedy and beam-search decoding of whole utterances
(`models.greedy_decode`, `models.beam_decode`) at the JAX benchmark's
shapes, with its arguments and JSON keys.  Each decode's ms is the
two-point marginal of `timing.bench_scalar_chain` on CUDA events, one
pair of chains of 2 and 6 decodes (the decode loop reads the device once
a round, so successive decodes are serialized).  Beside it, per decode:
the loop iterations (JAX's trip count, `decoding.LOOP_ITERATIONS`), the
host reads of the loop's flag (`decoding.HOST_READS`), the peak device
memory, and under the profiler (`profile_loss.device_profile`, device
activity only, PROFILED decodes) the kernels, the device's busy ms and its
idle share.  The decode loop (`utils.device_loop`) runs as CUDA graphs of
``unroll`` masked steps: the graph's capture ms (warm-up included), its
private pool's MiB, its kernels a step (one replay under the profiler over
``unroll``) and its device us a step (REPLAYS replays back to back on CUDA
events, over REPLAYS x unroll).  ``plain`` runs the loop eagerly on the
card instead (`device_loop._plain`, the plain version); its graph keys
are then None.

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_decode [N] [T] [V]
           [beam] [--unroll U ...] [--plain]
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
from warp_rnnt_tpu_torch.models.decoding import (
    HOST_READS,
    LAST_GRAPH,
    LOOP_ITERATIONS,
)
from warp_rnnt_tpu_torch.utils import device_loop

PROFILED = 1  # decodes under the profiler
TOP = 6  # kernels listed by device time a decode
REPLAYS = 20  # graph replays timed for the device us a step


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


def graph_numbers(name):
    """{capture_ms, graph_pool_mb, graph_kernels_per_step,
    graph_step_us} of the graph of decoder ``name``'s last drain."""
    entry = LAST_GRAPH[name]
    prof = device_profile(entry.replay, 1, cpu=False)
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
            / (REPLAYS * entry.unroll)}


def step_bound(model, rows):
    """(us, "bytes" or "operations"): the least time one decode step of
    ``rows`` hypotheses could take on this card.  Bytes: the joint's and
    the GRU cell's fp32 parameters read once, and the rows' embeddings.
    Operations: two a multiply-add of each row's products, the GRU's at
    the fp32 rate, the joint's at its compute dtype's (bf16 on the tensor
    cores, or fp32).  The rest of the step (argmax, top-k, the masks)
    moves a few KB."""
    hbm, fp32, bf16 = timing.card_rates()
    p = model.predictor
    gru = [p.weight_ih, p.weight_hh, p.bias_ih, p.bias_hn]
    joint = list(model.joint.parameters())
    n_gru = sum(t.numel() for t in gru)
    n_joint = sum(t.numel() for t in joint)
    nbytes = 4 * (n_gru + n_joint + rows * p.hidden)
    joint_rate = bf16 if model.joint.compute_dtype == torch.bfloat16 else fp32
    ops_s = 2 * rows * (n_gru / fp32 + n_joint / joint_rate)
    bytes_s = nbytes / hbm
    return (max(bytes_s, ops_s) * 1e6,
            "bytes" if bytes_s >= ops_s else "operations")


def decode_numbers(name, fn, feats, N, plain=False):
    """{name_ms, name_utts_per_s, name_iterations, name_host_reads,
    name_peak_mb, name_kernels, name_busy_ms, name_idle_share, name_top:
    the TOP kernels by device ms a decode, [ms, launches, name], and
    name_capture_ms, name_graph_pool_mb, name_graph_kernels_per_step,
    name_graph_step_us (None when ``plain``)} of ``fn(feats)``, a decoder
    whose loop counts in ``LOOP_ITERATIONS[name]`` and
    ``HOST_READS[name]``."""
    device_loop.clear()  # so the warm-up captures, and its capture ms counts
    fn(feats)  # warm up (cuBLAS and cuDNN handles, allocator, the graph)
    torch.cuda.synchronize()
    LOOP_ITERATIONS[name] = HOST_READS[name] = 0
    torch.cuda.reset_peak_memory_stats()
    fn(feats)
    torch.cuda.synchronize()
    iterations, reads = LOOP_ITERATIONS[name], HOST_READS[name]
    peak = torch.cuda.max_memory_allocated()
    ms = timing.bench_scalar_chain(fn, (feats,), 4, warmup=0, repeats=1,
                                   reduce_out=lambda out: out[1].sum())
    prof = device_profile(lambda: fn(feats), PROFILED, cpu=False)
    graph = (dict.fromkeys(("capture_ms", "graph_pool_mb",
                            "graph_kernels_per_step", "graph_step_us"))
             if plain else graph_numbers(name))
    return {f"{name}_ms": ms, f"{name}_utts_per_s": N / (ms / 1e3),
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
                 max_length=100, model=None, unroll=None, plain=False):
    """The decoders' numbers as a dict: the JAX benchmark's keys (N, T, V,
    hidden, beam, greedy_ms, greedy_utts_per_s, beam_ms, beam_utts_per_s),
    then the loop's (unroll, plain), per decoder `decode_numbers`' others
    and `step_bound` (name_step_bound_us, name_step_bound_by), and
    device.  The model is `init_model`'s seed 0 (as the JAX
    benchmark's key 0) unless ``model`` is given; the features are normal
    from seed 1, every frame valid.  ``unroll`` and ``plain`` as
    `loop_mode`."""
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

    r = {"N": N, "T": T, "V": V, "hidden": hidden, "beam": beam,
         "max_length": max_length}
    with loop_mode(plain, unroll):
        r.update(unroll=device_loop.UNROLL, plain=plain)
        g = decode_numbers("greedy", greedy, feats, N, plain)
        b = decode_numbers("beam", beam_fn, feats, N, plain)
    r.update({k: g[k] for k in ("greedy_ms", "greedy_utts_per_s")})
    r.update({k: b[k] for k in ("beam_ms", "beam_utts_per_s")})
    r.update(g)
    r.update(b)
    for name, rows in (("greedy", N), ("beam", N * beam)):
        r[f"{name}_step_bound_us"], r[f"{name}_step_bound_by"] = step_bound(
            model, rows)
    r["device"] = torch.cuda.get_device_name(0)
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cfg", nargs="*", type=int,
                        help="N T V beam (default 32 400 1024 4)")
    parser.add_argument("--unroll", nargs="+", type=int, default=[None])
    parser.add_argument("--plain", action="store_true")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for unroll in args.unroll:
        print(json.dumps(bench_decode(*(args.cfg or [32, 400, 1024, 4]),
                                      unroll=unroll, plain=args.plain)),
              flush=True)


if __name__ == "__main__":
    main()
