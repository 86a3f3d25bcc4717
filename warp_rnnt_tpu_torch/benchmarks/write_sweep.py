"""The dense gradient write (`flat_write`) over a sweep of V at a fixed
output size, on a CUDA device.

    python -m warp_rnnt_tpu_torch.benchmarks.write_sweep [--V 28 50 ...]
        [--dtypes fp32 bf16] [--tag x]

Each point writes (N, 150, 21) rows of V columns, N chosen so that the
output is about `OUT_BYTES` (2 GB), from seeded cotangents and labels.
It gives the kernel's chained ms (`timing.bench_scalar_chain`) and device
ms (a CUDA graph, `timing.bench_graph`) beside the byte bound (the output
written once, the cotangents and labels read once, over the card's rate
in `timing.card_rates`), and one `zero_()` of a tensor of the output's
shape and dtype, timed alike: the card's reachable store rate, a
yardstick only, since no torch call computes the write.  It reads only
`ops.flat_kernels.flat_grad_write` and `benchmarks.timing`, so a copy
placed in an older tree's `benchmarks/` and run there times that tree:
compare two trees in one call, in turns (old, new, new, old).  Prints the
card's line, then one JSON line a point.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.ops import flat_kernels as fk

SWEEP_V = (28, 50, 131, 1024, 5000)
SWEEP_DTYPES = ("fp32", "bf16")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16, "fp64": torch.float64}
T, U = 150, 21
OUT_BYTES = 2e9


def _first(d):
    return d.view(-1)[0].float()


def point(V, dtype="fp32"):
    """One point of the sweep: a dict of its shape, times and bound."""
    dt = DTYPES[dtype]
    size = torch.empty((), dtype=dt).element_size()
    N = max(1, round(OUT_BYTES / (T * U * V * size)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ct0 = torch.randn(N, T, U, generator=gen, device="cuda")
    ct1 = torch.randn(N, T, U, generator=gen, device="cuda")
    loc = torch.randint(0, V, (N, U), generator=gen, device="cuda",
                        dtype=torch.int32)
    args = (ct0, ct1, loc, 0, V, U * V, dt)
    rows = N * T * U
    moved = rows * V * size + 2 * rows * 4 + N * U * 4
    r = {"V": V, "dtype": dtype, "N": N, "T": T, "U": U,
         "out_bytes": rows * V * size,
         "ms": timing.bench_scalar_chain(fk.flat_grad_write, args, 10,
                                         reduce_out=_first),
         "device_ms": timing.bench_graph(fk.flat_grad_write, args, calls=8),
         "bound_ms": moved / timing.card_rates()[0] * 1e3, "bound_by": "bytes"}
    out = fk.flat_grad_write(*args)

    def zero(o):
        return o.zero_()

    r["zero_ms"] = timing.bench_scalar_chain(zero, (out,), 10, reduce_out=_first)
    r["zero_device_ms"] = timing.bench_graph(zero, (out,), calls=8)
    r["library_ms"] = None
    return r


def sweep(vs=SWEEP_V, dtypes=SWEEP_DTYPES):
    """Every (V, dtype) point, the memory handed back between points."""
    out = []
    for dtype in dtypes:
        for V in vs:
            out.append(point(V, dtype))
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    from warp_rnnt_tpu_torch.utils.profiling import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--V", type=int, nargs="+", default=list(SWEEP_V))
    ap.add_argument("--dtypes", nargs="+", default=list(SWEEP_DTYPES))
    ap.add_argument("--tag", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("write_sweep needs a CUDA device")
    print(f"card: {card_line()}", flush=True)
    for r in sweep(a.V, a.dtypes):
        print(json.dumps({"tag": a.tag, **r}), flush=True)


if __name__ == "__main__":
    main()
