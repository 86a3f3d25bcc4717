"""Device meshes over `torch.distributed` (counterpart of
`warp_rnnt_tpu/parallel/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group, 1-D ('data',) or 2-D ('data', 'model'): 'data' splits the
batch, 'model' the vocabulary of log-probs and of the joint's output
projection (`parallel.vocab`).  Where JAX places global arrays on devices,
a torch process holds only its own block: `shard_batch` cuts a tree of
global tensors into this rank's block of dim 0, on the rank's device.

The rank's device is explicit: `make_mesh` takes it (the card
``cuda:{LOCAL_RANK}`` unless the caller asks for another, "cpu" for the
CPU), makes a CUDA device current, and `mesh_device` reads it back.  Every
collective of the parallel tier is an all_reduce (SUM, MAX or MIN) on
tensors on that device, so one code path runs on gloo with CPU tensors,
gloo with CUDA tensors (several processes sharing one card) and NCCL.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """A rank's device: ``device`` as given when it is not a bare "cuda"
    ("cpu", or an indexed card such as "cuda:0", which several ranks may
    share), else the card ``cuda:{LOCAL_RANK}`` (the environment's
    LOCAL_RANK, else ``rank``, else the global rank)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = rank if rank is not None else dist.get_rank()
    return torch.device("cuda", int(local))


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              device=None) -> DeviceMesh:
    """A mesh over every rank of the default process group.

    The default 1-D ('data',) layout gives every rank a batch shard; pass
    ``axis_names=('data', 'model')`` and a 2-D shape for batch x vocab
    sharding (the default 2-D shape is (world, 1)).  Ranks are laid out
    row-major: rank r has 'data' index r // M and 'model' index r % M.
    ``device`` is this rank's device (see `rank_device`); a CUDA device is
    made current.  Needs an initialized default process group
    (`parallel.multihost.initialize`, or `torch.distributed` directly).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group:"
                           " call parallel.multihost.initialize or"
                           " torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = (n,) if len(axis_names) == 1 else (n, 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != len(axis_names) or torch.Size(mesh_shape).numel() != n:
        raise ValueError(f"mesh shape {mesh_shape} with axes {tuple(axis_names)}"
                         f" does not cover the {n} ranks")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = torch.arange(n, dtype=torch.int32).reshape(mesh_shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device for a "cuda"
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``; 0 for an axis the mesh does not
    have."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def all_reduce(x, mesh: DeviceMesh, axis: str, op=dist.ReduceOp.SUM):
    """``x`` all-reduced in place over ``axis`` of ``mesh`` (nothing to do
    for an axis the mesh does not have); returns ``x``."""
    if axis in (mesh.mesh_dim_names or ()):
        dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    return x


def min_max(x, mesh: Optional[DeviceMesh] = None, axis: Optional[str] = None):
    """(elementwise minimum, maximum) of ``x`` over ``axis`` of ``mesh``
    (every rank when ``mesh`` is None): one all_reduce MAX of ``x`` and its
    negation.  ``x`` is equal on every rank iff both equal it."""
    both = torch.cat([x.reshape(-1), -x.reshape(-1)])
    if mesh is None:
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
    else:
        all_reduce(both, mesh, axis, dist.ReduceOp.MAX)
    n = x.numel()
    return -both[n:].view_as(x), both[:n].view_as(x)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def reduce_sum(x, mesh: DeviceMesh, axis: str):
    """The SUM of ``x`` over ``axis``, differentiable: the backward passes
    the cotangent on unchanged.  Every rank of the axis then holds the same
    value and backpropagates the same cotangent into its own share, which
    is the share's exact gradient (an all-reduced backward, as
    `torch.distributed.nn`'s, would scale it by the axis size)."""
    return _ReduceSum.apply(x, mesh, axis)


class BatchSharding(NamedTuple):
    """This rank's block of dim 0 over a mesh axis: block ``index`` of
    ``count`` equal blocks, for tensors of ``ndim`` dimensions."""
    axis: str
    index: int
    count: int
    ndim: int

    def block(self, x):
        """The rank's block of dim 0 of the global tensor ``x``."""
        if x.dim() != self.ndim:
            raise ValueError(f"a {self.ndim}-D sharding got a {x.dim()}-D"
                             " tensor")
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"dim 0 of {n} does not divide over the"
                             f" {self.count} ranks of '{self.axis}'")
        size = n // self.count
        return x[self.index * size:(self.index + 1) * size]


def batch_sharding(mesh: DeviceMesh, ndim: int,
                   axis: str = "data") -> BatchSharding:
    """The block of dim 0 this rank holds of an ``ndim``-D tensor split
    over ``axis`` (the rest replicated)."""
    return BatchSharding(axis, axis_index(mesh, axis), axis_size(mesh, axis),
                         ndim)


def shard_batch(mesh: DeviceMesh, tree, axis: str = "data"):
    """Every tensor of ``tree`` (global, the same on every rank) cut to
    this rank's block of dim 0 over ``axis``, contiguous, on the rank's
    device."""
    dev = mesh_device(mesh)
    return tree_map(
        lambda x: batch_sharding(mesh, x.dim(), axis).block(x).to(dev)
        .contiguous(), tree)
