from warp_rnnt_tpu_torch.models.joint import Joint, carry_flax_joint, joint_logits

__all__ = ["Joint", "carry_flax_joint", "joint_logits"]
