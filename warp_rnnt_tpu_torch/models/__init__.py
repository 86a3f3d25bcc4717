from warp_rnnt_tpu_torch.models.beam_search import beam_decode
from warp_rnnt_tpu_torch.models.decoding import greedy_decode
from warp_rnnt_tpu_torch.models.joint import Joint, carry_flax_joint, joint_logits
from warp_rnnt_tpu_torch.models.streaming import (
    stream_finish,
    stream_init,
    stream_step,
)
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
    "beam_decode",
    "greedy_decode",
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
    "stream_init",
    "stream_step",
    "stream_finish",
]
