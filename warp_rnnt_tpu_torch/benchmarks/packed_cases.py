"""The packed gather/scatter kernels against their plain versions: the cases
and the one comparison, shared by `chip_smoke.py` and the `cuda`-marked
tests.

Both kernels move values and do at most one add (the two channels of the
cotangent where the label is the blank), in the same order as the plain
versions, so they must agree exactly, in every dtype: bit for bit, NaN
included (`NAN_CASE`: a buffer shorter than the lattice's rows and labels
outside [0, V)).
"""

from __future__ import annotations

import numpy as np
import torch

# name: (xn, yn, V, pad_rows, blank, dtype); the edge cases of the JAX
# package's `tests/test_packed_kernels.py`, plus V=50, pad rows and each
# input dtype.
CASES = {
    "generic ragged": ((9, 5, 7), (4, 2, 3), 13, 0, 0, torch.float32),
    "one sample": ((4,), (3,), 7, 0, 0, torch.float32),
    "yn=0 sample": ((3, 6), (0, 2), 9, 0, 0, torch.float32),
    "T spans many rows": ((40, 33, 17, 29), (11, 7, 0, 11), 33, 0, 0,
                          torch.float32),
    "T<U": ((2, 2), (5, 5), 5, 0, 0, torch.float32),
    "pad rows": ((6, 4), (2, 3), 11, 7, 0, torch.float32),
    "blank=3": ((5, 4), (2, 1), 9, 0, 3, torch.float32),
    "V=50": ((30, 12, 21), (9, 4, 0), 50, 3, 0, torch.float32),
    "bf16": ((9, 5, 7), (4, 2, 3), 13, 2, 0, torch.bfloat16),
    "fp16": ((9, 5, 7), (4, 2, 3), 33, 1, 1, torch.float16),
    "fp64": ((9, 5, 7), (4, 2, 3), 5, 1, 0, torch.float64),
}


# A case outside what the loss lets through, for the NaN rule: a buffer 5
# rows short of the lattice's 35 (the last sample's last frame and the last
# row of the frame before lie past it), and labels V and -1.
NAN_CASE = ((4, 3, 5), (2, 0, 3), 9, -5, 0, torch.float32)
NAN_LABELS = {0: 9, 3: -1}  # packed label index: its value


def _finish(xs, ys, xn, yn, T, U, blank, rng, device):
    """The rest of a case: loc_rows and a random (N, T, U, 2) cotangent."""
    from warp_rnnt_tpu_torch.ops.packed_kernels import loc_rows

    N = len(xn)
    i32 = dict(dtype=torch.int32, device=device)
    xn_t, yn_t = torch.tensor(xn, **i32), torch.tensor(yn, **i32)
    ys_t = torch.tensor(ys, **i32)
    loc = loc_rows(ys_t, xn_t, yn_t, U, blank)
    ct = torch.tensor(rng.randn(N, T, U, 2), dtype=torch.float32, device=device)
    return dict(xs=xs, ys=ys_t, xn=xn_t, yn=yn_t, T=T, U=U, blank=blank,
                loc=loc, ct=ct)


def make_case(xn, yn, V, pad_rows=0, blank=0, dtype=torch.float32, seed=0,
              device="cuda", labels=None):
    """A small packed case from numpy: xs (rows + pad_rows, V) in ``dtype``
    (pad_rows < 0: a buffer that many rows short), packed labels in [0, V)
    without the blank (``labels``: {index: value} overrides), lengths,
    T = max(xn), U = max(yn) + 1, loc_rows and a cotangent."""
    rng = np.random.RandomState(seed)
    xn, yn = np.asarray(xn), np.asarray(yn)
    rows = int((xn * (yn + 1)).sum())
    xs = torch.tensor(rng.randn(rows + pad_rows, V), device=device).to(dtype)
    drawn = rng.randint(0, V - 1, int(yn.sum()))
    ys = np.where(drawn >= blank, drawn + 1, drawn)
    for i, value in (labels or {}).items():
        ys[i] = value
    return _finish(xs, ys, xn, yn, int(xn.max()), int(yn.max()) + 1, blank,
                   rng, device)


def nan_case(device="cuda", seed=0):
    """`NAN_CASE` with `NAN_LABELS`."""
    return make_case(*NAN_CASE, seed=seed, device=device, labels=NAN_LABELS)


def full_case(N, T, L, V, seed=0, pad_rows=13, device="cuda"):
    """A full-width case with random lengths as `bench_joint.py` makes them
    (xn in [T/2, T], yn in [L/2, L] labels) from numpy's seeded generator,
    and log_softmax log-probs made on ``device``.  The lattice is sized by
    the lengths: T = max(xn), U = max(yn) + 1."""
    rng = np.random.RandomState(seed)
    xn = rng.randint(T // 2, T + 1, size=N)
    yn = rng.randint(L // 2, L + 1, size=N)
    rows = int((xn * (yn + 1)).sum())
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.log_softmax(
        torch.randn(rows + pad_rows, V, generator=gen, device=device), dim=-1)
    ys = rng.randint(1, V, int(yn.sum()))
    return _finish(xs, ys, xn, yn, int(xn.max()), int(yn.max()) + 1, 0, rng,
                   device)


def compare(pk, case):
    """Each kernel (through `pk`, `warp_rnnt_tpu_torch.ops.packed_kernels`)
    against its plain version on the case's tensors: the gather's lattice,
    loc and pref, and the scatter from them, bit for bit.  Returns
    {kernel: max abs err}; raises AssertionError."""
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    blank, T, U = case["blank"], case["T"], case["U"]
    got = pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
    want = pk.packed_gather_lattice_plain(xs, ys, xn, yn, blank, T, U)
    errs = {"packed_gather": _exact("packed_gather", got, want)}
    args = (case["ct"], *got[1:], xn, yn, blank, xs.shape[0], xs.shape[1],
            xs.dtype)
    errs["packed_scatter"] = _exact("packed_scatter", (pk.packed_scatter(*args),),
                                    (pk.packed_scatter_plain(*args),))
    return errs


def _bits(x):
    """The tensor's bits as integers of its width (NaN equal to NaN)."""
    return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[x.element_size()])


def _exact(name, got, want):
    for k, p in zip(got, want):
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"{name}: {tuple(k.shape)} {k.dtype} !="
                                 f" {tuple(p.shape)} {p.dtype}")
        if not torch.equal(_bits(k), _bits(p)):
            diff = (k.double() - p.double()).abs().nan_to_num(float("inf"))
            raise AssertionError(f"{name}: kernel != plain version, max abs"
                                 f" err {float(diff.max())}")
    return 0.0
