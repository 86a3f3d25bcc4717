"""Parity of the port's dense gradient write (`warp_rnnt_tpu_torch/ops/
flat_kernels.py`) with the JAX package's gather VJP, and the kernel's tiling.

On the CPU `flat_grad_write` runs its plain version, which is held here
against `jax.vjp` of `warp_rnnt_tpu.functional.gather.gather_blank_label`
(the XLA compare-select write; JAX's Pallas writer runs only at V >= 128,
and `tests/test_torch_lattice.py` holds it there), exactly, at small V,
in fp32, fp16 and bf16: rows whose label is the blank (both terms add) and
rows with a +inf, -inf or NaN cotangent.  JAX takes the cotangent in the
output's dtype, so the fp16 and bf16 cases feed both sides cotangents that
the dtype holds exactly.

A non-finite cotangent: the port multiplies in every element, as JAX's
Pallas writer `_flat_write_kernel` does, so the row is NaN in every column
the cotangent's term does not reach (inf * 0); held against the Pallas
writer in interpret mode.  JAX's XLA VJP agrees for the blank's cotangent,
but XLA rewrites the label term's multiply by a converted compare into a
select, so a non-finite label cotangent leaves the other columns at the
blank term there; the test holds the port to NaN and JAX's XLA write to
the select on exactly those rows, and to equal values everywhere else
(the select also writes +0 where the multiply gives -0: a negative
cotangent times 0).  Against the Pallas writer the bits are equal.

The kernel against its plain version needs the card (`cuda`); its cases
are `warp_rnnt_tpu_torch/benchmarks/flat_write_cases.py`, which
`chip_smoke.py` runs too: every V and dtype of the grid, a column offset,
partial last blocks, rows that are not whole vectors
(`test_flat_write_kernel_matches_twin` in `tests/test_torch_lattice.py`),
and outputs past 2^31 elements, bit for bit.  The kernel's rows a block
(`kernel_block_rows`, a rule the C source alone holds) are read from the
built library, so their test needs the card too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu.functional.gather import gather_blank_label
from warp_rnnt_tpu.ops import flat_kernels as jax_flat
from warp_rnnt_tpu_torch.benchmarks import flat_write_cases as fwc
from warp_rnnt_tpu_torch.ops import flat_kernels

_JNP = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}


def _same_bits(got, want):
    """Two float32 arrays equal bit for bit, NaN where the other has NaN."""
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])


def _same_values(got, want):
    """Equal values, NaN where the other has NaN, -0 equal to +0."""
    np.testing.assert_array_equal(got, want)


def _jax_write(ct0, ct1, loc_rows, blank, V, dtype):
    """JAX's gather VJP: the (N, T, U, V) gradient of `gather_blank_label`
    for the cotangent (ct0, ct1), as float32 numpy."""
    N, T, U = ct0.shape
    xs = jnp.zeros((N, T, U, V), _JNP[dtype])
    loc = jnp.broadcast_to(jnp.asarray(loc_rows)[:, None, :], (N, T, U))
    _, vjp = jax.vjp(lambda x: gather_blank_label(x, loc, blank), xs)
    ct = jnp.stack([jnp.asarray(ct0), jnp.asarray(ct1)], -1).astype(_JNP[dtype])
    (d,) = vjp(ct)
    assert d.dtype == _JNP[dtype]
    return np.asarray(d.astype(jnp.float32))


def _inputs(V, dtype, seed=3):
    """Small seeded cotangents (rounded to the output dtype, so JAX's
    cotangent holds them exactly) and labels, from `fwc.make_inputs`."""
    ct0, ct1, loc, blank, *_ = fwc.make_inputs(
        2, 5, 4, V, dtype, blank=V // 2 if dtype != "fp32" else 0, seed=seed)
    dt = fwc.DTYPES[dtype]
    return ct0.to(dt).float(), ct1.to(dt).float(), loc, blank


@pytest.mark.parametrize("dtype", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("V", fwc.SMALL_V)
def test_plain_write_matches_jax_gather_vjp(V, dtype):
    ct0, ct1, loc, blank = _inputs(V, dtype)
    N, T, U = ct0.shape
    got = flat_kernels.flat_grad_write(ct0, ct1, loc, blank, V, U * V,
                                       fwc.DTYPES[dtype])
    assert got.shape == (N, T, U * V) and got.dtype == fwc.DTYPES[dtype]
    got = got.float().view(N, T, U, V).numpy()
    want = _jax_write(ct0.numpy(), ct1.numpy(), loc.numpy(), blank, V, dtype)
    # rows whose label cotangent alone is non-finite: XLA's select (above)
    c0, c1 = ct0.numpy(), ct1.numpy()
    select = np.isfinite(c0) & ~np.isfinite(c1)
    label = np.arange(V) == loc.numpy()[:, None, :, None]
    off = select[..., None] & ~label
    assert np.isnan(got[off]).all() and (off.any() or V == 1)
    blank_term = np.where(np.arange(V) == blank, c0[..., None], np.float32(0))
    _same_values(want[off], np.broadcast_to(blank_term, want.shape)[off])
    _same_values(got[~off], want[~off])
    # the inputs hold each kind of non-finite row and rows whose label is
    # the blank
    assert (~np.isfinite(c0)).any() and select.any()
    assert (loc == blank).any()


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("which", ["ct0", "ct1"])
def test_nonfinite_cotangent_makes_its_row_nan(which, value):
    """inf * 0 is NaN: every column the non-finite term does not reach is
    NaN, in the port and in JAX's Pallas writer alike (interpret mode)."""
    V, blank = 128, 0
    ct0, ct1 = torch.ones(1, 8, 3), torch.ones(1, 8, 3)
    loc = torch.tensor([[3, 5, blank]], dtype=torch.int32)
    (ct0 if which == "ct0" else ct1)[0, 1, 1] = float(value)
    got = flat_kernels.flat_grad_write(ct0, ct1, loc, blank, V, 3 * V)
    rows = got.view(1, 8, 3, V)
    hit = blank if which == "ct0" else 5
    assert rows[0, 1, 1][torch.arange(V) != hit].isnan().all()
    assert rows.isnan().sum() == V - 1 + (value != value)
    want = jax_flat.flat_grad_write(jnp.asarray(ct0.numpy()),
                                    jnp.asarray(ct1.numpy()),
                                    jnp.asarray(loc.numpy()), blank, V, 3 * V,
                                    interpret=True)
    _same_bits(got.numpy(), np.asarray(want))


def test_cases_cover_the_tiling():
    """The card's cases reach every edge of the tiling that the rows a block
    do not decide (those are `test_block_rows_rule`'s)."""
    vecs = [fwc.vectors(c) for c in fwc.CASES.values()]
    assert any(not v["whole_vectors"] for v in vecs)
    assert any(v["whole_vectors"] for v in vecs)
    assert any(v["tail"] for v in vecs)
    assert {c["V"] for c in fwc.CASES.values()} >= {*fwc.SMALL_V, 128, 5000}
    assert {c["dtype"] for c in fwc.CASES.values()} == set(fwc.DTYPES)
    assert any(c["offset"] for c in fwc.CASES.values())
    for c in fwc.BIG_CASES.values():
        assert c["N"] * c["T"] * c["U"] * c["V"] > 2**31


@pytest.mark.parametrize("name", sorted(fwc.CASES))
def test_case_inputs_pass_the_checks(name):
    """Each card case, at T=5, through the CPU route: the wrapper takes its
    arguments, and its non-finite rows come out NaN."""
    args = fwc.make_inputs(**{**fwc.CASES[name], "T": 5})
    d = flat_kernels.flat_grad_write(*args[:6], out_dtype=args[6],
                                     offset=args[7])
    N, T, U = args[0].shape
    assert d.shape == (N, T, args[5]) and d.dtype == args[6]
    assert d.view(N, T, U, -1)[0, 0, 0].isnan().sum() >= args[4] - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(fwc.DTYPES))
def test_block_rows_rule(cuda_device, dtype):
    """The library's rows a block: every block's span starts on 16 bytes;
    1 to 1024 rows; about 32 KB of output, one row a block from V past a
    span; and the grid's cases of this dtype reach a partial last block
    of many, at the most rows a block."""
    dt = fwc.DTYPES[dtype]
    size = torch.empty((), dtype=dt).element_size()
    for V in [*range(1, 300), 1000, 1024, 4999, 5000, 5001, 8192, 50257, 64000]:
        R = flat_kernels.kernel_block_rows(V, dt)
        assert 1 <= R <= 1024
        assert R * V * size % 16 == 0
        if V * size % 16 == 0:
            assert R == max(1, min(32768 // size // V, 1024))
        assert R * V * size <= 32768 + 16 * V
    assert flat_kernels.kernel_block_rows(5000, torch.float32) == 1
    assert flat_kernels.kernel_block_rows(50, torch.float32) == 164
    tilings = [fwc.tiling(c, flat_kernels.kernel_block_rows(c["V"], dt))
               for c in fwc.CASES.values() if c["dtype"] == dtype]
    assert any(t["partial"] and t["blocks"] > 1 for t in tilings)
    assert any(t["rows_a_block"] == 1024 for t in tilings)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fwc.BIG_CASES))
def test_flat_write_kernel_past_2_31_elements(cuda_device, name):
    if torch.cuda.get_device_properties(cuda_device).total_memory < 40 * 2**30:
        pytest.skip("needs 40 GiB of device memory")
    r = fwc.compare_big(flat_kernels, name, device=cuda_device)
    assert r["elements"] > 2**31 and r["max_abs_err"] == 0.0
