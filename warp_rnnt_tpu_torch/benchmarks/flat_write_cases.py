"""The dense gradient write (`ops.flat_kernels.flat_grad_write`) against its
plain version: the cases and the one comparison, shared by `chip_smoke.py`
(phase 3, and the output past 2^31 elements in phase 13) and the
`cuda`-marked tests of `tests/test_torch_lattice.py` and
`tests/test_torch_flat_write.py`.

The kernel computes the plain version's multiply form element by element
and rounds once to the output dtype, so the two must agree bit for bit
(`same`: equal bits, NaN where the other has NaN).  Every case's inputs hold
rows whose label is the blank (both terms add), cotangents past fp16's
range, and +inf, -inf and NaN cotangents, whose whole rows are NaN
(inf * 0) on both sides.  The grid of V x dtype covers the kernel's tiling
(`flat_kernels.kernel_block_rows`): V below a 16-byte vector (1, 2), V
whose rows are not a whole number of vectors (127, 131, and 50 in fp32),
rows many blocks long, a row count that is not a multiple of a block's
rows and an output that ends off a vector (a scalar tail), and V=5000 (a
row a block).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"fp32": torch.float32, "fp64": torch.float64, "fp16": torch.float16,
          "bf16": torch.bfloat16}
SMALL_V = (1, 2, 28, 50, 127, 131)
GRID_V = (*SMALL_V, 128, 5000)  # 128: a row of whole vectors in every dtype
GRID_SHAPE = (3, 401, 6)  # 7218 rows: several blocks at every V below 5000

# name: dict(N, T, U, V, dtype, blank, offset); offset=None is the whole
# vocabulary, else the block [offset, offset + V) of one `vocab` labels index.
CASES = {
    f"V={V} {d}": dict(N=GRID_SHAPE[0], T=GRID_SHAPE[1], U=GRID_SHAPE[2], V=V,
                       dtype=d, blank=0 if d in ("fp32", "fp64") else V // 2,
                       offset=None)
    for V in GRID_V for d in DTYPES
}
CASES.update({
    "offset 2500 of 5000 fp32": dict(N=2, T=37, U=6, V=2500, dtype="fp32",
                                     blank=0, offset=2500, vocab=5000),
    "offset 2500 of 5000 bf16": dict(N=2, T=37, U=6, V=2500, dtype="bf16",
                                     blank=2600, offset=2500, vocab=5000),
    "offset 25 of 50 fp16": dict(N=3, T=401, U=6, V=25, dtype="fp16",
                                 blank=30, offset=25, vocab=50),
})
# Outputs past 2^31 elements: the main path's N=144 (9.07 GB in fp32).
BIG_CASES = {f"N=144 {d}": dict(N=144, T=150, U=21, V=5000, dtype=d, blank=0,
                                offset=None) for d in ("fp32", "bf16")}


def make_inputs(N, T, U, V, dtype="fp32", blank=0, offset=None, vocab=None,
                seed=0, device="cpu"):
    """fp32 cotangents (N, T, U) and int32 labels (N, U) from numpy, and the
    write's other arguments: (ct0, ct1, loc_rows, blank, V, U * V,
    out_dtype, offset)."""
    rng = np.random.RandomState(seed)
    ct0 = rng.randn(N, T, U).astype(np.float32)
    ct1 = rng.randn(N, T, U).astype(np.float32)
    ct0[:, 1 % T] *= 1e5  # past fp16's range: inf there, finite elsewhere
    ct0[0, 0, 0] = np.inf
    ct0[-1, -1, 0] = -np.inf
    ct0[N // 2, 2 % T, 1 % U] = np.nan
    ct1[0, T // 2, U - 1] = np.nan
    ct1[-1, 0, U // 2] = -np.inf
    if offset is None:
        loc = rng.randint(0, V, size=(N, U))
        loc[:, -1] = blank  # the last lattice row: both terms add
        loc[0, 0] = blank
    else:
        loc = rng.randint(0, vocab, size=(N, U))
        loc[:, -1] = blank
        loc[0, 0] = offset  # the block's first and last columns
        loc[-1, 0] = offset + V - 1
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(ct0, **f32), torch.tensor(ct1, **f32),
            torch.tensor(loc, **i32), blank, V, U * V, DTYPES[dtype], offset)


def _bits(x):
    return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        x.element_size()])


def same(got, want):
    """Equal bits everywhere but at NaN, and NaN at the same places."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = got.isnan()
    return (torch.equal(nan, want.isnan())
            and torch.equal(_bits(got)[~nan], _bits(want)[~nan]))


def vectors(case):
    """Whether a case's rows are whole 16-byte vectors, and the elements of
    the scalar tail that ends its output."""
    w = 16 // torch.empty((), dtype=DTYPES[case["dtype"]]).element_size()
    rows = case["N"] * case["T"] * case["U"]
    return dict(whole_vectors=case["V"] % w == 0, tail=rows * case["V"] % w)


def tiling(case, R):
    """What the kernel's tiling makes of a case with R rows a block
    (`flat_kernels.kernel_block_rows`): blocks, whether the last block is
    partial, and `vectors`."""
    rows = case["N"] * case["T"] * case["U"]
    return dict(rows_a_block=R, blocks=-(-rows // R), partial=rows % R != 0,
                **vectors(case))


def compare(fk, name, device="cuda", seed=0):
    """The kernel (through `fk`, `warp_rnnt_tpu_torch.ops.flat_kernels`)
    against its plain version on the same card, bit for bit.  Returns the
    case's `tiling` with max_abs_err; raises AssertionError."""
    case = CASES[name]
    args = make_inputs(**case, seed=seed, device=device)
    got = fk.flat_grad_write(*args[:6], out_dtype=args[6], offset=args[7])
    want = fk.flat_grad_write_plain(*args[:6], out_dtype=args[6],
                                    offset=args[7])
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"flat_write {name}: kernel != plain version,"
                             f" max abs err {_max_err(got, want)}")
    return {**tiling(case, fk.kernel_block_rows(case["V"], args[6])),
            "max_abs_err": 0.0}


def compare_big(fk, name, device="cuda", chunk=16, seed=0):
    """A case past 2^31 elements: the kernel's whole output against the
    plain version computed `chunk` samples at a time (the plain version's
    temporaries are several times its output), bit for bit."""
    case = BIG_CASES[name]
    args = make_inputs(**case, seed=seed, device=device)
    ct0, ct1, loc = args[:3]
    got = fk.flat_grad_write(*args[:6], out_dtype=args[6])
    if got.numel() < 2**31:
        raise AssertionError(f"flat_write {name}: {got.numel()} elements")
    for s in range(0, case["N"], chunk):
        part = slice(s, s + chunk)
        want = fk.flat_grad_write_plain(ct0[part], ct1[part], loc[part],
                                        *args[3:6], out_dtype=args[6])
        if not same(got[part], want):
            raise AssertionError(f"flat_write {name} samples {s}..: kernel !="
                                 f" plain version, max abs err"
                                 f" {_max_err(got[part], want)}")
        del want
    torch.cuda.synchronize()
    return {"elements": got.numel(),
            **tiling(case, fk.kernel_block_rows(case["V"], args[6])),
            "max_abs_err": 0.0}


def _max_err(got, want):
    diff = (got.double() - want.double()).abs()
    both_nan = got.isnan() & want.isnan()
    return float(diff.masked_fill(both_nan, 0).nan_to_num(float("inf")).max())
