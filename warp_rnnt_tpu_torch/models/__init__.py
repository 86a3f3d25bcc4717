from warp_rnnt_tpu_torch.models.joint import Joint, carry_flax_joint

__all__ = ["Joint", "carry_flax_joint"]
