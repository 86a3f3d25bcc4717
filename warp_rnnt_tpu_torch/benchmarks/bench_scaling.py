"""Data-parallel scaling: lattices/s against the number of ranks
(counterpart of `warp_rnnt_tpu/benchmarks/bench_scaling.py`).

Each rank holds 8 lattices (T=150, U=20 labels + 1), pre-gathered (N, T,
U+1, 2) log-probs with ``blank=-1``, and runs loss+grad through
`parallel.rnnt_loss_shard_map(reduction="mean")`: the lattice kernel on
its samples, then one all_reduce of the scalar (and the even-split check's
all_reduce and host read).  The step is chained on CUDA events
(`timing.bench_grad_chain`: the gradient is the next input); a world's
time is its slowest rank's, and its throughput N x ranks / time.

    python -m warp_rnnt_tpu_torch.benchmarks.bench_scaling [--ranks R]

spawns worlds of 1, 2, 4, ... up to R ranks (default: the cards present),
one card a rank over NCCL, and prints one JSON row a world with the
efficiency against 1 rank.  NCCL across cards needs as many cards as ranks:
on a machine with one card only the 1-rank row can be measured, and no
efficiency is claimed from it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.parallel import make_mesh, rnnt_loss_shard_map
from warp_rnnt_tpu_torch.parallel.mesh import mesh_device
from warp_rnnt_tpu_torch.parallel.multihost import spawn


def lattices_per_second(mesh, per_rank_batch=8, T=150, U=20, iters=20):
    """Lattices a second of the sharded loss+grad over ``mesh``'s 'data'
    ranks (this rank's part of a collective measurement: every rank of
    the mesh calls it)."""
    dev = mesh_device(mesh)
    N = per_rank_batch
    g = torch.Generator(device=dev).manual_seed(dist.get_rank())
    xs = torch.randn(N, T, U + 1, 2, generator=g, device=dev) - 5.0
    ys = torch.randint(1, 28, (N, U), generator=g, device=dev,
                       dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device=dev)
    yn = torch.full((N,), U, dtype=torch.int32, device=dev)

    def step(x):
        x = x.detach().requires_grad_()
        loss = rnnt_loss_shard_map(mesh, x, ys, xn, yn, reduction="mean",
                                   blank=-1)
        loss.backward()
        return loss, x.grad

    ms = torch.tensor([timing.bench_grad_chain(step, xs, iters)], device=dev)
    dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    return N * dist.get_world_size() / (float(ms) / 1000.0)


def _rank_main(rank, device, out_path):
    lps = lattices_per_second(make_mesh(device=device))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(lps, f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_scaling needs a CUDA device")
    top = args.ranks or torch.cuda.device_count()
    rows, d = [], 1
    with tempfile.TemporaryDirectory() as tmp:
        while d <= top:
            path = os.path.join(tmp, f"{d}.json")
            spawn(_rank_main, d, (path,), device="cuda")
            with open(path) as f:
                lps = json.load(f)
            rows.append({"ranks": d, "lattices_per_s": lps})
            d *= 2
    for r in rows:
        r["efficiency"] = r["lattices_per_s"] / (rows[0]["lattices_per_s"]
                                                 * r["ranks"])
        r["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
