"""Published peaks of the card, the denominators of every roofline share.

Copied from `warp_rnnt_tpu_torch/benchmarks/timing.py` (`card_rates`), so
that the yardstick does not move with the program: HBM bytes/s, fp32
FLOP/s outside the tensor cores and dense bf16 tensor-core FLOP/s, from
NVIDIA's data sheets; the H100 SXM where no word of the card's name
matches.  The rates assume the card's full power limit.
"""

from __future__ import annotations

CARD_RATES = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
              "H200": (4.8e12, 67e12, 989e12)}
RATES_SXM = (3.35e12, 67e12, 989e12)


def card_rates(name: str):
    """(bytes/s, fp32 FLOP/s, bf16 FLOP/s) of the card called ``name``."""
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    return RATES_SXM
