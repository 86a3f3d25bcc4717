from warp_rnnt_tpu_torch.functional.core import rnnt_core, rnnt_core_with_internals
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss, rnnt_loss_with_internals
from warp_rnnt_tpu_torch.functional.from_logits import rnnt_loss_from_logits
from warp_rnnt_tpu_torch.functional.joint_loss import rnnt_loss_joint

__all__ = [
    "rnnt_core",
    "rnnt_core_with_internals",
    "rnnt_loss",
    "rnnt_loss_from_logits",
    "rnnt_loss_joint",
    "rnnt_loss_with_internals",
]
