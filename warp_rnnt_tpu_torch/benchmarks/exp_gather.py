"""The blank/label gather and its dense VJP in every formulation the JAX
package's gather experiments tried (counterpart of `scripts/exp_colgather.py`
and `scripts/exp_pallas_gather.py`), timed on a CUDA device.

    python -m warp_rnnt_tpu_torch.benchmarks.exp_gather <variant|all> <N> [--device cpu]

The shape is T=150, U=21, V=5000 fp32 (N=32: 2.0 GB; N=128: 7.5 GiB, the
experiments' shape; N=144: 9.07 GB, past 2^31 elements), with xs, labels
(N, U) in [1, V) and cotangents from a seeded `torch.Generator`; blank 0.
The torch formulations stand for the XLA ones:

  taa      `torch.gather` on the flat (N, T, U*V) view with broadcast
           (N, T, U) indices (XLA's take_along_axis)
  col      whole-T columns by advanced indexing, (N, 2U) indices (XLA's
           take with (T, 1) slices)
  col4d    the same on (N, T, U, V), two columns per (n, u)
  taa4d    `torch.gather` on (N, T, U, V), the blank as a slice
  slice    the blank through a stride-V view, the label by `torch.gather`
  kernel   the port's column-gather kernel (`gather_columns_flat`)
  stream   `gather_fwd` (4-D in, (2, N, T, U) fp32)
  sparse   `gather_fwd_sparse` (flat in, (2, N, U, T) fp32)
  lattice  `gather_lattice` (4-D in, the (N, T, U, 2) lattice: the main
           path's gather on the card)
  scatter  `scatter_bwd` ((N, T, U) cotangents -> dense (N, T, U, V))

Every variant is first held against the plain gather (`gather_fwd_plain`;
scatter: `scatter_bwd_plain` on the first and last sample), exactly, then
timed with `benchmarks/timing.py`: chained (CUDA events; at these sizes
mostly the host's launch path) and on the device alone (`bench_graph`: a
CUDA graph replayed, the L2 cache flushed before each call).  One line per
variant: both ms, the operand's GiB, and the function's byte bound at an H100
SXM's 3.35 TB/s: a gather moves one 32-byte sector per gathered value plus
its output; the scatter writes the dense gradient once.  It runs on `cuda`
unless ``--device cpu`` is given, which checks values and times nothing.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.ops import gather_kernels as gk

T, U, V = 150, 21, 5000
BLANK = 0
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SECTOR = 32  # bytes a device-memory read moves at least


def make(N, device="cuda", seed=SEED):
    """xs (N, T, U, V) fp32 and its flat view, labels (N, U) int32 in
    [1, V), cotangents ct_b, ct_l (N, T, U) fp32."""
    g = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn(N, T, U, V, generator=g, device=device)
    labels = torch.randint(1, V, (N, U), generator=g, device=device,
                           dtype=torch.int32)
    ct = torch.randn(2, N, T, U, generator=g, device=device)
    return dict(xs=xs, xs3=xs.view(N, T, U * V), labels=labels, ct_b=ct[0],
                ct_l=ct[1])


def _row_offsets(labels):
    return torch.arange(U, device=labels.device) * V


def taa(d):
    xs3, lab = d["xs3"], d["labels"]
    N = xs3.shape[0]
    off = _row_offsets(lab)
    lab3 = (lab.long() + off)[:, None, :].expand(N, T, U)
    blank3 = (off + BLANK)[None, None, :].expand(N, T, U)
    return torch.stack([torch.gather(xs3, 2, blank3),
                        torch.gather(xs3, 2, lab3)], dim=-1)


def col(d):
    xs3, lab = d["xs3"], d["labels"]
    N = xs3.shape[0]
    off = _row_offsets(lab)
    idx = torch.cat([(off + BLANK).expand(N, U), lab.long() + off], dim=1)
    n = torch.arange(N, device=lab.device)[:, None]
    out = xs3[n, :, idx]  # (N, 2U, T)
    return torch.stack([out[:, :U], out[:, U:]], dim=-1).transpose(1, 2)


def col4d(d):
    xs, lab = d["xs"], d["labels"]
    N = xs.shape[0]
    idx = torch.stack([torch.full_like(lab, BLANK), lab], dim=-1).long()
    n = torch.arange(N, device=lab.device)[:, None, None]
    u = torch.arange(U, device=lab.device)[None, :, None]
    return xs[n, :, u, idx].permute(0, 3, 1, 2)  # (N, U, 2, T) -> (N, T, U, 2)


def taa4d(d):
    xs, lab = d["xs"], d["labels"]
    N = xs.shape[0]
    loc = lab.long()[:, None, :, None].expand(N, T, U, 1)
    return torch.stack([xs[..., BLANK], torch.gather(xs, 3, loc)[..., 0]],
                       dim=-1)


def slice_blank(d):
    xs3, lab = d["xs3"], d["labels"]
    N = xs3.shape[0]
    lab3 = (lab.long() + _row_offsets(lab))[:, None, :].expand(N, T, U)
    return torch.stack([xs3[:, :, BLANK::V], torch.gather(xs3, 2, lab3)],
                       dim=-1)


def kernel(d):
    out = gk.gather_columns_flat(d["xs3"],
                                 gk.blank_label_cols(d["labels"], BLANK, V))
    return torch.stack([out[..., :U], out[..., U:]], dim=-1)


def stream(d):
    return gk.gather_fwd(d["xs"], d["labels"], BLANK)


def sparse(d):
    return gk.gather_fwd_sparse(d["xs3"], d["labels"], BLANK, V)


def lattice(d):
    return gk.gather_lattice(d["xs"], d["labels"], BLANK)


def scatter(d):
    return gk.scatter_bwd(d["ct_b"], d["ct_l"], d["labels"], BLANK, V)


VARIANTS = {"taa": taa, "col": col, "col4d": col4d, "taa4d": taa4d,
            "slice": slice_blank, "kernel": kernel, "stream": stream,
            "sparse": sparse, "lattice": lattice, "scatter": scatter}


def check(variant, d, ref):
    """Run one variant once and hold it against the plain version, exactly;
    ``ref`` is `reference(d)`.  Raises AssertionError."""
    out = VARIANTS[variant](d)
    if variant == "scatter":
        for n in (0, out.shape[0] - 1):
            s = slice(n, n + 1)
            want = gk.scatter_bwd_plain(d["ct_b"][s], d["ct_l"][s],
                                        d["labels"][s], BLANK, V)
            if not torch.equal(out[s], want):
                raise AssertionError(f"scatter: sample {n} != plain version")
        return
    if variant == "stream":
        out = out.permute(1, 2, 3, 0)
    elif variant == "sparse":
        out = out.permute(1, 3, 2, 0)
    if not torch.equal(out, ref):
        raise AssertionError(f"{variant}: != the plain gather")


def reference(d):
    """The (N, T, U, 2) blank/label lattice by the plain gather."""
    return gk.gather_lattice_plain(d["xs"], d["labels"], BLANK)


def bound_bytes(variant, N):
    """Bytes the function must move: a gather one sector per gathered value
    (each sits in its own) and its fp32 output; the scatter the two
    cotangents and labels in, the dense gradient out."""
    if variant == "scatter":
        return N * T * U * V * 4 + 2 * N * T * U * 4 + N * U * 4
    values = N * T * 2 * U
    return values * (SECTOR + 4)


def first_value(out):
    """One element of an output (or of the first of a tuple of outputs):
    a timing chain's dependence, read cheaply."""
    x = out[0] if isinstance(out, tuple) else out
    return x[(0,) * x.dim()]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variant", choices=(*VARIANTS, "all"))
    parser.add_argument("N", type=int)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_gather needs a CUDA device (or --device cpu)")
    names = list(VARIANTS) if args.variant == "all" else [args.variant]
    d = make(args.N, args.device)
    ref = reference(d)
    gib = d["xs"].nbytes / 2**30
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        print(f"card: {card}")
    for name in names:
        check(name, d, ref)
        bound = bound_bytes(name, args.N) / HBM_BYTES_PER_S * 1e3
        if args.device == "cpu":
            ms = "ms not measured (cpu)"
        else:
            fn = VARIANTS[name]
            chained = timing.bench_scalar_chain(lambda x: fn(d), (d["xs"],), 20,
                                                reduce_out=first_value)
            # the scatter's output (GBs) is its own L2 flush
            graph = (dict(calls=4, flush_bytes=0) if name == "scatter"
                     else {})
            device = timing.bench_graph(lambda x: fn(d), (d["xs"],), **graph)
            ms = f"{chained} ms chained, {device} ms device (graph replay)"
        print(f"{name} N={args.N}: {ms}  ({gib:.2f} GiB operand)  bound"
              f" {bound} ms (bytes at 3.35 TB/s)  [{card or 'cpu'}]")


if __name__ == "__main__":
    main()
