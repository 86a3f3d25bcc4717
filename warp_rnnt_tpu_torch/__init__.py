"""warp_rnnt_tpu_torch: the RNN-Transducer loss in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `warp_rnnt_tpu`, file for file (`functional/`,
`ops/`, `models/`, `utils/`, `benchmarks/`).  It imports neither JAX nor
`warp_rnnt_tpu`.
The loss runs where its input tensors are: on a CUDA device through the
kernels in `csrc/` (built with nvcc on first use), on the CPU through plain
torch code.
"""

from warp_rnnt_tpu_torch.functional import (
    rnnt_core,
    rnnt_core_with_internals,
    rnnt_loss,
    rnnt_loss_from_logits,
    rnnt_loss_joint,
    rnnt_loss_with_internals,
)
from warp_rnnt_tpu_torch.ops.fused_joint import rnnt_loss_fused_joint

__version__ = "0.1.0"

__all__ = [
    "rnnt_core",
    "rnnt_core_with_internals",
    "rnnt_loss",
    "rnnt_loss_from_logits",
    "rnnt_loss_fused_joint",
    "rnnt_loss_joint",
    "rnnt_loss_with_internals",
    "__version__",
]
