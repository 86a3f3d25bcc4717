"""Runnable examples: ``python -m warp_rnnt_tpu_torch.examples.<name>``."""
