"""Multi-process start-up (counterpart of
`warp_rnnt_tpu/parallel/multihost.py`).

  * `initialize(...)`: the default process group from arguments or the
    JAX module's environment variables (WARP_RNNT_NUM_PROCESSES,
    WARP_RNNT_COORDINATOR, WARP_RNNT_PROCESS_ID); a no-op at one process.
  * `pod_mesh(...)`: a mesh over every rank ('data', or ('data', 'model')
    with a model axis of 1).
  * `global_batch(...)`: the counterpart of
    `jax.make_array_from_process_local_data`.  A torch process holds only
    its shard, so this checks that every rank passes the same shapes and
    returns the local tensors on the rank's device.
  * `spawn(fn, nprocs, ...)`: ``nprocs`` local processes, each with the
    default process group initialized (a ``file://`` rendezvous in a
    temporary directory), running ``fn(rank, device, *args)``; used by
    the command lines (`parallel.dryrun`, `examples.train_toy --data-parallel`,
    `benchmarks.bench_scaling`).

The backend follows the device: NCCL for "cuda", gloo for "cpu".  A caller
may name another (gloo with CUDA tensors is how several processes share
one card), but there is no silent fallback from one to the other: NCCL
with the CPU raises.  Nothing here reads a cluster's environment beyond
the three variables; the coordinator is a ``host:port`` (TCP) or any
`torch.distributed` init URL (``file://...``).
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from warp_rnnt_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_device,
    min_max,
    rank_device,
)


def backend_for(device, backend: Optional[str] = None) -> str:
    """The process group's backend for ``device``: ``backend`` when given
    (NCCL only with a CUDA device), else "nccl" for "cuda" and "gloo" for
    "cpu"."""
    kind = torch.device(device).type
    if backend is None:
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"no backend for device {device}")
        return "nccl" if kind == "cuda" else "gloo"
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Initialize the default process group (no-op at one process).

    ``device`` is this process's device (default: the card of its local
    rank); the backend follows it unless named (`backend_for`)."""
    num_processes = num_processes or int(
        os.environ.get("WARP_RNNT_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    address = coordinator_address or os.environ.get(
        "WARP_RNNT_COORDINATOR", "localhost:12321")
    rank = (process_id if process_id is not None
            else int(os.environ.get("WARP_RNNT_PROCESS_ID", "0")))
    dist.init_process_group(
        backend_for(rank_device(device, rank), backend),
        init_method=address if "://" in address else f"tcp://{address}",
        world_size=num_processes, rank=rank)


def pod_mesh(axis_names: Sequence[str] = ("data",), device=None):
    """A mesh over every rank of the default process group."""
    return make_mesh(None, axis_names, device)


def global_batch(mesh, tree, axis: str = "data"):
    """Each process's local batch shard (the same shapes on every rank)
    -> the same tensors on the rank's device.

    The shapes are checked across every rank with `mesh.min_max` (the
    length of the shape vector, then the vector); a rank that differs
    raises ValueError on every rank.  ``axis`` is the mesh
    axis the batch is split over, as in JAX; the shards stay local."""
    del axis  # the shards are already local; kept for JAX's signature
    dev = mesh_device(mesh)
    leaves, spec = tree_flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    shape = [len(leaves)]
    for x in leaves:
        shape += [x.dim(), *x.shape]
    vec = torch.tensor(shape, dtype=torch.int64, device=dev)
    lo, hi = min_max(torch.tensor([vec.numel()], device=dev))
    if lo != hi:
        raise ValueError("global_batch: the ranks pass trees of different"
                         " structure or rank")
    lo, hi = min_max(vec)
    if not (torch.equal(lo, vec) and torch.equal(hi, vec)):
        raise ValueError(f"global_batch: shapes differ across ranks (this"
                         f" rank {shape[1:]}, max {hi.tolist()[1:]},"
                         f" min {lo.tolist()[1:]})")
    return tree_unflatten([x.to(dev) for x in leaves], spec)


def _child(rank, fn, nprocs, init, backend, device, args):
    dev = rank_device(device, rank)
    dist.init_process_group(backend_for(dev, backend), init_method=init,
                            world_size=nprocs, rank=rank)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), backend: Optional[str] = None,
          device=None, timeout: float = 600.0) -> None:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes ("spawn"
    start method), each with the default process group initialized for its
    device (`mesh.rank_device`: "cuda" puts rank r on ``cuda:r``; the
    backend follows the device unless named).
    Returns when every process exits 0; if one fails, or ``timeout``
    seconds pass, the others are killed and RuntimeError is raised.
    ``fn`` must be importable by name (a module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_child, args=(
            rank, fn, nprocs, init, backend, device, tuple(args)))
            for rank in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"spawned ranks exited with {codes} (a negative"
                           " code: killed after another failed or after"
                           f" {timeout} s)")
