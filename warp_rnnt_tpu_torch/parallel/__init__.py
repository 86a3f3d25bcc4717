"""The parallel tier over `torch.distributed` (counterpart of
`warp_rnnt_tpu/parallel/`): meshes (`mesh`), multi-process start-up
(`multihost`), the data-parallel losses (`loss_parallel`), vocabulary
parallelism (`vocab`), the sharded train step (`train_parallel`) and the
dry run (`dryrun`).  Gloo on the CPU, NCCL on the card; every collective
is an all_reduce."""

from warp_rnnt_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_batch
from warp_rnnt_tpu_torch.parallel.loss_parallel import (
    rnnt_loss_shard_map,
    rnnt_loss_sharded,
)

__all__ = [
    "batch_sharding",
    "make_mesh",
    "shard_batch",
    "rnnt_loss_shard_map",
    "rnnt_loss_sharded",
]
