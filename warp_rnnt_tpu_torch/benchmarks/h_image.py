"""The fused joint's h image kernel (`ops.fused_joint._hidden_image`) on a
CUDA device, at the fused slice's lattice (N=16, T=150, U=21, full lengths)
and the widths where the sliced route runs it.

    python -m warp_rnnt_tpu_torch.benchmarks.h_image [--H 512 640 1024] [--tag x]

For each H it prints one JSON line: `times` (chained, device and host
times), the byte bound (`bound_bytes` at the card's memory rate,
`timing.card_rates`), the image's own bytes (padded to `bwd_plan`'s width,
zero rows included) and the tanhf the kernel evaluates (`tanhf`).
`chip_smoke.py` times the kernel through `times`.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.ops import fused_joint as fj

SEED = 0
N, T, U = 16, 150, 21


def times(a, c, xn, dims):
    """The kernel on (a, c, xn, dims): chained ms
    (`timing.bench_scalar_chain`), device ms (`timing.bench_graph`, CUDA
    graph, L2 flushed) and host us a call (`timing.bench_host`)."""
    args = (a, c, xn, dims)
    return {"ms": timing.bench_scalar_chain(
                fj._hidden_image, args, 10,
                reduce_out=lambda out: out.view(-1)[0]),
            "device_ms": timing.bench_graph(fj._hidden_image, args),
            "host_us": timing.bench_host(fj._hidden_image, args)}


def bound_bytes(n, t, u, h):
    """a and c read as fp32, the lengths read, h written once as bf16 at
    the unpadded width."""
    return (n * t * h + n * u * h) * 4 + n * 4 + n * t * u * h * 2


def tanhf(xn, u, hp):
    """The tanhf the kernel evaluates: live rows x the padded width."""
    return int(xn.long().sum()) * u * hp


def measure(H):
    if not torch.cuda.is_available():
        raise SystemExit("h_image needs a CUDA device")
    Hp, S = fj.bwd_plan(H)
    gen = torch.Generator(device="cuda").manual_seed(SEED + H)
    a = torch.randn(N, T, H, generator=gen, device="cuda")
    c = torch.randn(N, U, H, generator=gen, device="cuda")
    a, c, _ = fj.pad_h(a, c, None, Hp)
    a, c = a.contiguous(), c.contiguous()
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    return {
        "H": H, "Hp": Hp, "S": S, **times(a, c, xn, (N, T, U, Hp, 0, S)),
        "bound_ms": bound_bytes(N, T, U, H) / timing.card_rates()[0] * 1e3,
        "image_bytes": fj.n_tiles(N, T, U) * 64 * Hp * 2,
        "tanhf": tanhf(xn, U, Hp),
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--H", type=int, nargs="+", default=[512, 640, 1024])
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    for H in args.H:
        print(json.dumps({"tag": args.tag, **measure(H)}), flush=True)


if __name__ == "__main__":
    main()
