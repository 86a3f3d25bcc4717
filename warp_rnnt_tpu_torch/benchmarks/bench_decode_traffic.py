"""Decoding a run of requests of varied batch size and length on a CUDA
device: what a server pays per request, the decode loop's graph captures
included (no JAX counterpart).

REQUESTS requests (N, T) are drawn from ``--seed``: N from BATCHES, T
uniform in [T_MIN, T_MAX], each sample's valid length uniform in
[T // 2, T] and the first sample's T.  The model is `init_model`'s seed 0
at `bench_decode`'s width (V 1024, hidden 512, beam 4, max_length 100),
TF32 off.  After one warm-up decode of each decoder (cuBLAS and cuDNN
handles) the graph cache is emptied, and then each decoder takes the
requests twice in a row: pass 1 from the empty cache, so it pays every
capture, pass 2 over the same requests.  A request's ms is host wall
time from the call to its tokens and lengths on the host.

It uses only the package's public decoders, so it times any tree of the
port: run it by path with that tree's root on PYTHONPATH (the line names
the package it loaded).  On a tree without `utils.device_loop` the
captures are null.

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_decode_traffic
           [--seed S] [--requests R]
Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import warp_rnnt_tpu_torch
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode, init_model

BATCHES = (1, 8, 32)
T_MIN, T_MAX = 64, 1024
REQUESTS = 12
V, F, HIDDEN, BEAM, MAX_LENGTH = 1024, 80, 512, 4, 100


def requests(seed, n, device="cuda"):
    """[(feats (N, T, F), xn (N,) int32)] on ``device``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        N = int(rng.choice(BATCHES))
        T = int(rng.randint(T_MIN, T_MAX + 1))
        xn = rng.randint(T // 2, T + 1, size=N).astype(np.int32)
        xn[0] = T
        feats = rng.randn(N, T, F).astype(np.float32)
        out.append((torch.from_numpy(feats).to(device),
                    torch.from_numpy(xn).to(device)))
    return out


def _served(out):
    """A decode's tokens and lengths on the host."""
    return [x.cpu() for x in out[:2]]


def _loop():
    try:
        from warp_rnnt_tpu_torch.utils import device_loop
    except ImportError:
        return None
    return device_loop


def bench_traffic(seed=0, n=REQUESTS):
    """{"package", "requests": [[N, T]], per decoder and pass p (1, 2):
    name_pass{p}_ms (the sum), name_pass{p}_request_ms, name_pass{p}_captures
    (None without the device loop), "device"}."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_traffic needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(0, vocab_size=V, feat_dim=F, N=32, T=400, U=8,
                       device="cuda", encoder_hidden=HIDDEN,
                       predictor_hidden=HIDDEN, joint_hidden=HIDDEN)[0]
    decoders = {
        "greedy": lambda f, xn: greedy_decode(model, f, xn, MAX_LENGTH),
        "beam": lambda f, xn: beam_decode(model, f, xn, MAX_LENGTH,
                                          beam_size=BEAM)}
    reqs = requests(seed, n)
    loop = _loop()
    r = {"package": warp_rnnt_tpu_torch.__file__, "seed": seed,
         "requests": [list(f.shape[:2]) for f, _ in reqs]}
    for name, decode in decoders.items():
        f, xn = reqs[0]
        _served(decode(f[:, :T_MIN], xn.clamp(max=T_MIN)))
        if loop is not None:
            loop.clear()
        for p in (1, 2):
            before = loop.STATS["captures"] if loop else None
            ms = []
            for f, xn in reqs:
                t0 = time.perf_counter()
                _served(decode(f, xn))
                ms.append((time.perf_counter() - t0) * 1e3)
            r[f"{name}_pass{p}_ms"] = sum(ms)
            r[f"{name}_pass{p}_request_ms"] = ms
            r[f"{name}_pass{p}_captures"] = (
                loop.STATS["captures"] - before if loop else None)
    r["device"] = torch.cuda.get_device_name(0)
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=REQUESTS)
    args = parser.parse_args(argv)
    print(json.dumps(bench_traffic(args.seed, args.requests)), flush=True)


if __name__ == "__main__":
    main()
