from warp_rnnt_tpu_torch.utils.lse import NEG_INF, logrec_combine, safe_logaddexp

__all__ = ["NEG_INF", "logrec_combine", "safe_logaddexp"]
