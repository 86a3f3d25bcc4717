"""Numerically safe log-space primitives (torch counterpart of
`warp_rnnt_tpu/utils/lse.py`).

Padded lattice cells are -inf in the scan implementation, so every routine
here returns -inf, never NaN, for ``logaddexp(-inf, -inf)``.
"""

import torch

NEG_INF = float("-inf")


def safe_logaddexp(a, b):
    """log(exp(a) + exp(b)), returning -inf (not NaN) when both are -inf."""
    mx = torch.maximum(a, b)
    d = -(a - b).abs()  # NaN when both are infinite with the same sign
    out = mx + torch.log1p(torch.exp(d))
    return torch.where(torch.isfinite(mx), out, mx)


def logrec_combine(x, y):
    """Associative combine for the log-space linear recurrence.

    Solves ``a[t] = logaddexp(a[t-1] + m[t], b[t])`` as a scan over elements
    ``(m, b)``:

        (m1, b1) . (m2, b2) = (m1 + m2, logaddexp(b1 + m2, b2))

    After an inclusive scan the ``b`` component at position t is the
    recurrence solution.  ``m[0]`` is never consumed.
    """
    m1, b1 = x
    m2, b2 = y
    return m1 + m2, safe_logaddexp(b1 + m2, b2)
