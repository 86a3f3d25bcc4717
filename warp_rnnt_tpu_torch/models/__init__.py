from warp_rnnt_tpu_torch.models.joint import Joint, carry_flax_joint, joint_logits
from warp_rnnt_tpu_torch.models.transducer import (
    ConvBlock,
    Encoder,
    Predictor,
    Transducer,
    carry_flax_transducer,
    init_model,
    make_train_step,
    transducer_loss_fn,
)

__all__ = [
    "Joint",
    "carry_flax_joint",
    "joint_logits",
    "ConvBlock",
    "Encoder",
    "Predictor",
    "Transducer",
    "carry_flax_transducer",
    "init_model",
    "make_train_step",
    "transducer_loss_fn",
]
