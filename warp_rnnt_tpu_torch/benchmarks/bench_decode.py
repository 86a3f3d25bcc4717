"""Decoding throughput on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_decode.py`).

Batched greedy and beam-search decoding of whole utterances
(`models.greedy_decode`, `models.beam_decode`) at the JAX benchmark's
shapes, with its arguments and JSON keys.  Each decode's ms is the
two-point marginal of `timing.bench_scalar_chain` on CUDA events, one
pair of chains of 2 and 6 decodes (the decode's loop reads the device
once an iteration, so successive decodes are serialized).  Beside it, per
decode: the loop iterations (each one host read,
`decoding.LOOP_ITERATIONS`), the peak device memory, and under the
profiler (`profile_loss.device_profile`, device activity only, PROFILED
decodes) the kernels, the device's busy ms and its idle share.

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_decode [N] [T] [V]
                                                             [beam]
Prints one JSON line.  Needs a CUDA device; the CLI turns TF32 off in
cuBLAS and cuDNN, as `chip_smoke.py` does.
"""

from __future__ import annotations

import json
import sys

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode, init_model
from warp_rnnt_tpu_torch.models.decoding import LOOP_ITERATIONS

PROFILED = 1  # decodes under the profiler
TOP = 6  # kernels listed by device time a decode


def decode_numbers(name, fn, feats, N):
    """{name_ms, name_utts_per_s, name_iterations, name_peak_mb,
    name_kernels, name_busy_ms, name_idle_share, name_top: the TOP kernels
    by device ms a decode, [ms, launches, name]} of ``fn(feats)``, a
    decoder whose loop counts in ``LOOP_ITERATIONS[name]``."""
    fn(feats)  # warm up (cuBLAS and cuDNN handles, allocator)
    torch.cuda.synchronize()
    LOOP_ITERATIONS[name] = 0
    torch.cuda.reset_peak_memory_stats()
    fn(feats)
    torch.cuda.synchronize()
    iterations = LOOP_ITERATIONS[name]
    peak = torch.cuda.max_memory_allocated()
    ms = timing.bench_scalar_chain(fn, (feats,), 4, warmup=0, repeats=1,
                                   reduce_out=lambda out: out[1].sum())
    prof = device_profile(lambda: fn(feats), PROFILED, cpu=False)
    return {f"{name}_ms": ms, f"{name}_utts_per_s": N / (ms / 1e3),
            f"{name}_iterations": iterations,
            f"{name}_peak_mb": peak / 2**20,
            f"{name}_kernels": prof["kernels_per_call"],
            f"{name}_busy_ms": prof["busy_ms"],
            f"{name}_idle_share": prof["idle_share"],
            f"{name}_top": [[ms, n, key[:60]]
                            for ms, n, key in prof["rows"][:TOP]]}


def bench_decode(N=32, T=400, V=1024, beam=4, feat_dim=80, hidden=512,
                 max_length=100, model=None):
    """The decoders' numbers as a dict: the JAX benchmark's keys (N, T, V,
    hidden, beam, greedy_ms, greedy_utts_per_s, beam_ms, beam_utts_per_s),
    then per decoder `decode_numbers`' others, and device.  The model is
    `init_model`'s seed 0 (as the JAX benchmark's key 0) unless ``model``
    is given; the features are normal from seed 1, every frame valid."""
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
    g = decode_numbers("greedy", greedy, feats, N)
    b = decode_numbers("beam", beam_fn, feats, N)
    r.update({k: g[k] for k in ("greedy_ms", "greedy_utts_per_s")})
    r.update({k: b[k] for k in ("beam_ms", "beam_utts_per_s")})
    r.update(g)
    r.update(b)
    r["device"] = torch.cuda.get_device_name(0)
    return r


def main(*args):
    cfg = [int(a) for a in args] or [32, 400, 1024, 4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(bench_decode(*cfg)), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
