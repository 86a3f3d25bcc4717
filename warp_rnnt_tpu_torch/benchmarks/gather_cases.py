"""The column-gather kernels and the scatter write against their plain
versions: the cases and the one comparison, shared by `chip_smoke.py` and
the `cuda`-marked tests.

The kernels move values and at most widen them to fp32 (the write does one
add where the label is the blank, in the plain version's order), so kernel
and plain version must agree exactly (`torch.equal`), in every dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from warp_rnnt_tpu_torch.benchmarks.packed_cases import _exact

# name: (N, T, U, V, blank, dtype, K).  Every case also holds a column in
# the last partial 128-lane window (C - 1), columns outside [0, C), labels
# outside [0, V) (both give 0) and lab == blank on the last row.
CASES = {
    "T=13": (2, 13, 4, 300, 0, torch.float32, 40),
    "C<128": (2, 5, 3, 20, 0, torch.float32, 7),
    "K=80": (2, 9, 40, 7, 0, torch.float32, 80),
    "N=1": (1, 13, 4, 300, 0, torch.float32, 8),
    "blank=3": (3, 13, 5, 33, 3, torch.float32, 12),
    "bf16": (2, 13, 4, 300, 0, torch.bfloat16, 40),
    "fp16": (2, 7, 3, 129, 1, torch.float16, 9),
    "fp64": (2, 7, 3, 131, 0, torch.float64, 9),
}


def make_case(N, T, U, V, blank=0, dtype=torch.float32, K=8, seed=0,
              device="cuda"):
    """A small case from numpy: xs (N, T, U, V) in ``dtype`` and its flat
    view xs3, cols (N, K), labels_ext (N, U) (labels other than the blank,
    the blank on the last row), fp32 cotangents (N, T, U)."""
    rng = np.random.RandomState(seed)
    C = U * V
    xs = torch.tensor(rng.randn(N, T, U, V), device=device).to(dtype)
    cols = rng.randint(0, C, (N, K))
    cols[0, 0] = C - 1
    cols[-1, -1] = C
    cols[0, -2] = -1
    labels = rng.randint(0, V - 1, (N, U))
    labels = np.where(labels >= blank, labels + 1, labels)
    labels[:, -1] = blank
    labels[-1, 0] = V + 7
    labels[0, U - 2] = -1
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(xs=xs, xs3=xs.view(N, T, C), cols=torch.tensor(cols, **i32),
                labels_ext=torch.tensor(labels, **i32), blank=blank, V=V,
                ct_b=torch.tensor(rng.randn(N, T, U), **f32),
                ct_l=torch.tensor(rng.randn(N, T, U), **f32))


def compare(gk, case):
    """Each kernel (through `gk`, `warp_rnnt_tpu_torch.ops.gather_kernels`)
    against its plain version on the case's tensors: exact.  Returns
    {kernel: max abs err}; raises AssertionError."""
    xs, xs3, lab = case["xs"], case["xs3"], case["labels_ext"]
    blank, V = case["blank"], case["V"]
    runs = {
        "gather_columns": (gk.gather_columns_flat, gk.gather_columns_flat_plain,
                           (xs3, case["cols"])),
        "gather_fwd": (gk.gather_fwd, gk.gather_fwd_plain, (xs, lab, blank)),
        "gather_fwd_sparse": (gk.gather_fwd_sparse, gk.gather_fwd_sparse_plain,
                              (xs3, lab, blank, V)),
        "flat_write": (gk.scatter_bwd, gk.scatter_bwd_plain,
                       (case["ct_b"], case["ct_l"], lab, blank, V)),
    }
    errs = {}
    for name, (kernel, plain, args) in runs.items():
        got, want = kernel(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        errs[name] = _exact(name, got, want)
    return errs
