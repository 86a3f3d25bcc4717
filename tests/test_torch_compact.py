"""Parity of the PyTorch port's compact (packed) layout with the JAX package,
on the CPU.

The same seeded numpy inputs go through the JAX functions (the Pallas
movement kernels in interpret mode where forced, as
`tests/test_packed_kernels.py` runs them) and the port (the plain torch
versions of the CUDA kernels, and the plain composition):
  * `packed_lattice` forward (exact: values are moved, not computed) and
    its gradient (atol 1e-5), pad rows included, every input dtype; the
    gather's plain version (lattice, loc, prefix sums) exact against JAX's
    `packed_lattice`, `_loc_rows` and cumulative sums, and its NaN rule;
  * ``rnnt_loss(compact=True)`` costs (rtol 1e-5) and packed gradients
    (`GRAD_TOL`) against JAX's, with JAX's movement kernels forced on and
    off; `rnnt_loss_compact_with_internals`; the golden compact batch;
  * compact against the port's padded `rnnt_loss` on the same values;
  * the validation errors, the no-grad route and the input dtype.
Kernel-against-plain-version tests need the card and are marked `cuda`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from _torch_port_helpers import cuda_device, tt  # noqa: F401  (fixture)
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
import warp_rnnt_tpu_torch.functional.core as core
from test_compact import EXPECTED_COMPACT_GRADS, _pack
from warp_rnnt_tpu.functional import compact as jcompact
from warp_rnnt_tpu.ops import packed_kernels as jpk
from warp_rnnt_tpu_torch.benchmarks import packed_cases
from warp_rnnt_tpu_torch.functional import compact
from warp_rnnt_tpu_torch.ops import packed_kernels as pk

TOL = dict(rtol=1e-5, atol=1e-5)
# A gradient entry is exp(alpha + lp + beta - ll); the two packages' fp32
# doubling scans round differently, and at T=40, U=12 (|ll| ~ 1e2) that
# leaves a few 1e-5 of relative error in the exponent.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(name, seed=0):
    """A `packed_cases` case on the CPU, and its numpy arrays."""
    xn, yn, V, pad, blank, dtype = packed_cases.CASES[name]
    case = packed_cases.make_case(xn, yn, V, pad, blank, dtype, seed, "cpu")
    return case, {k: case[k].float().numpy() if k == "xs" else case[k].numpy()
                  for k in ("xs", "ys", "xn", "yn", "loc")}


@pytest.mark.parametrize("name", list(packed_cases.CASES))
def test_packed_lattice_matches_jax(name):
    """Forward and the gradient of sum(out**2) against JAX's packed_lattice
    (interpret mode).  The port keeps the input dtype: bf16 and fp16
    gradients are held within one rounding of their own dtype."""
    case, npc = _case(name)
    T, U, blank = case["T"], case["U"], case["blank"]
    x = case["xs"].clone().requires_grad_()
    out = pk.packed_lattice(x, case["ys"], case["xn"], case["yn"], blank, T, U)
    (out ** 2).sum().backward()
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape

    args = (jnp.asarray(npc["loc"]), jnp.asarray(npc["xn"]),
            jnp.asarray(npc["yn"]), blank, T, U)
    jout, vjp = jax.vjp(lambda z: jpk.packed_lattice(z, *args),
                        jnp.asarray(npc["xs"]))
    (jgrad,) = vjp(2 * jout)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    rtol = {torch.bfloat16: 8e-3, torch.float16: 1e-3}.get(x.dtype, 0.0)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(jgrad),
                               rtol=rtol, atol=1e-5)
    rows = int((npc["xn"] * (npc["yn"] + 1)).sum())
    assert (x.grad[rows:] == 0).all()


def test_loc_rows_matches_jax():
    for name in packed_cases.CASES:
        case, npc = _case(name)
        want = jpk._loc_rows(jnp.asarray(npc["ys"]), jnp.asarray(npc["xn"]),
                             jnp.asarray(npc["yn"]), case["U"], case["blank"])
        np.testing.assert_array_equal(npc["loc"], np.asarray(want))
    empty = pk.loc_rows(torch.zeros(0, dtype=torch.int32), *tt(
        np.array([2, 3], np.int32), np.array([0, 0], np.int32)), 1, 4)
    np.testing.assert_array_equal(empty.numpy(), [[4], [4]])


@pytest.mark.parametrize("name", list(packed_cases.CASES))
def test_gather_lattice_plain_matches_jax(name):
    """The gather's plain version, what the CPU path and the card's
    comparison use: its lattice equals JAX's `packed_lattice` (interpret
    mode), its loc JAX's `_loc_rows`, its prefix sums the cumulative sums
    of the lengths, all exactly."""
    case, npc = _case(name)
    T, U, blank = case["T"], case["U"], case["blank"]
    lat, loc, pref = pk.packed_gather_lattice_plain(
        case["xs"], case["ys"], case["xn"], case["yn"], blank, T, U)
    assert lat.dtype == torch.float32 and lat.shape == (len(npc["xn"]), T, U, 2)
    jargs = (jnp.asarray(npc["xn"]), jnp.asarray(npc["yn"]))
    jloc = jpk._loc_rows(jnp.asarray(npc["ys"]), *jargs, U, blank)
    jout = jpk.packed_lattice(jnp.asarray(npc["xs"]), jloc, *jargs, blank, T, U)
    np.testing.assert_array_equal(lat.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
    sizes = npc["xn"].astype(np.int64) * (npc["yn"] + 1)
    yn64 = npc["yn"].astype(np.int64)
    np.testing.assert_array_equal(pref.numpy(), [np.cumsum(sizes) - sizes,
                                                 np.cumsum(yn64) - yn64])


def test_gather_lattice_nan_rule():
    """A cell whose packed row lies past the buffer, or whose label lies
    outside [0, V), is NaN in both channels; every other cell is its value
    or 0 (`packed_cases.NAN_CASE`)."""
    case = packed_cases.nan_case("cpu")
    xs, xn, yn = case["xs"], case["xn"].numpy(), case["yn"].numpy()
    T, U = case["T"], case["U"]
    lat, loc, _ = pk.packed_gather_lattice_plain(
        xs, case["ys"], case["xn"], case["yn"], 0, T, U)
    pos, valid = (x.numpy() for x in pk.lattice_rows(case["xn"], case["yn"],
                                                     T, U))
    lab = np.broadcast_to(loc.numpy()[:, None, :], pos.shape)
    bad = valid & ((pos >= xs.shape[0]) | (lab < 0) | (lab >= xs.shape[1]))
    assert bad.sum() == 13 and (pos[valid] >= xs.shape[0]).sum() == 5
    lat = lat.numpy()
    assert np.isnan(lat[bad]).all() and not np.isnan(lat[~bad]).any()
    ok = valid & ~bad
    x = xs.numpy()
    np.testing.assert_array_equal(lat[ok][:, 0], x[pos[ok], 0])
    np.testing.assert_array_equal(lat[ok][:, 1], x[pos[ok], lab[ok]])
    assert (lat[~valid] == 0).all()


def _loss_both(name, force_kernel, monkeypatch, fastemit=0.0):
    """(costs, grad) of the port's and JAX's compact loss under a weighted
    sum, on log_softmax log-probs of a packed case."""
    case, npc = _case(name, seed=3)
    xs = torch.log_softmax(case["xs"].float(), -1).numpy()
    w = np.random.RandomState(4).rand(len(npc["xn"])).astype(np.float32)
    blank = case["blank"]
    x = torch.tensor(xs, requires_grad=True)
    out = wt.rnnt_loss(x, case["ys"], case["xn"], case["yn"], compact=True,
                       blank=blank, fastemit_lambda=fastemit)
    (out * torch.tensor(w)).sum().backward()

    monkeypatch.setattr(jcompact, "_FORCE_KERNEL", force_kernel)
    jout, jgrad = jax.value_and_grad(
        lambda z: (warp_rnnt_tpu.rnnt_loss(
            z, jnp.asarray(npc["ys"]), npc["xn"], npc["yn"], compact=True,
            blank=blank, fastemit_lambda=fastemit, impl="scan") * w).sum()
    )(jnp.asarray(xs))
    return (out, x.grad), (jout, jgrad), w


@pytest.mark.parametrize("force_kernel", [False, True])
@pytest.mark.parametrize("name", ["generic ragged", "one sample", "yn=0 sample",
                                  "T spans many rows", "T<U", "pad rows",
                                  "blank=3", "V=50"])
def test_compact_loss_matches_jax(name, force_kernel, monkeypatch):
    (out, grad), (jout, jgrad), w = _loss_both(name, force_kernel, monkeypatch)
    np.testing.assert_allclose(float((out.detach() * torch.tensor(w)).sum()),
                               float(jout), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_compact_fastemit_matches_jax(monkeypatch):
    (out, grad), (jout, jgrad), w = _loss_both("generic ragged", None,
                                               monkeypatch, fastemit=0.3)
    np.testing.assert_allclose(float((out.detach() * torch.tensor(w)).sum()),
                               float(jout), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("name", ["generic ragged", "pad rows", "blank=3"])
def test_with_internals_matches_jax(name):
    case, npc = _case(name, seed=5)
    xs = torch.log_softmax(case["xs"].float(), -1)
    got = compact.rnnt_loss_compact_with_internals(
        xs, case["ys"], case["xn"], case["yn"], blank=case["blank"],
        fastemit_lambda=0.1)
    want = jcompact.rnnt_loss_compact_with_internals(
        jnp.asarray(xs.numpy()), jnp.asarray(npc["ys"]), jnp.asarray(npc["xn"]),
        jnp.asarray(npc["yn"]), blank=case["blank"], fastemit_lambda=0.1,
        impl="scan")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_golden_compact_batch(reduction):
    """The reference's golden compact batch: costs and packed gradients."""
    packed, packed_ys, xn, yn = _pack(golden.FORWARD_BATCH)
    x = torch.tensor(packed, requires_grad=True)
    out = wt.rnnt_loss(x, *tt(packed_ys, xn.astype(np.int32),
                              yn.astype(np.int32)),
                       compact=True, reduction=reduction)
    out.sum().backward()
    costs = np.asarray(golden.FORWARD_BATCH["expected_costs"])
    want = {"none": costs, "sum": costs.sum(), "mean": costs.mean()}[reduction]
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4, atol=2e-5)
    scale = 1.0 / len(costs) if reduction == "mean" else 1.0
    np.testing.assert_allclose(x.grad.numpy(), EXPECTED_COMPACT_GRADS * scale,
                               rtol=1e-4, atol=2e-5)


def _to_padded(case, xs):
    """The packed values scattered into (N, T, U, V) (zeros elsewhere) and
    (N, U-1) labels (the blank past each sample's labels)."""
    N, T, U = len(case["xn"]), case["T"], case["U"]
    n, t, u = (x.numpy() for x in pk.row_coordinates(
        int((case["xn"] * (case["yn"] + 1)).sum()), case["xn"], case["yn"])[:3])
    padded = np.zeros((N, T, U, xs.shape[1]), np.float32)
    padded[n, t, u] = xs[: len(n)]
    labels = case["loc"].numpy()[:, :-1]
    return padded, labels, (n, t, u)


@pytest.mark.parametrize("name", ["generic ragged", "yn=0 sample", "T<U",
                                  "pad rows", "blank=3"])
def test_compact_matches_padded_port(name):
    """The same values through the compact and the padded port give the same
    lattice: costs equal (rtol 1e-6), packed gradients equal the padded ones
    at valid cells, pad rows 0."""
    case, _ = _case(name, seed=6)
    xs = torch.log_softmax(case["xs"].float(), -1).numpy()
    padded, labels, (n, t, u) = _to_padded(case, xs)
    blank = case["blank"]
    x = torch.tensor(xs, requires_grad=True)
    c = wt.rnnt_loss(x, case["ys"], case["xn"], case["yn"], compact=True,
                     blank=blank)
    c.sum().backward()
    p = torch.tensor(padded, requires_grad=True)
    cp = wt.rnnt_loss(p, torch.tensor(labels), case["xn"], case["yn"],
                      blank=blank)
    cp.sum().backward()
    np.testing.assert_allclose(c.detach().numpy(), cp.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy()[: len(n)],
                               p.grad.numpy()[n, t, u], rtol=0, atol=1e-7)
    assert (x.grad[len(n):] == 0).all()


def test_no_grad_route_runs_beta_only(monkeypatch):
    case, _ = _case("generic ragged")
    xs = torch.log_softmax(case["xs"], -1)
    args = (case["ys"], case["xn"], case["yn"])
    with_grad = wt.rnnt_loss(xs.clone().requires_grad_(), *args,
                             compact=True).detach()

    def _boom(*a, **k):
        raise AssertionError("alpha+grads sweep ran")

    monkeypatch.setattr(core, "_forward_backward_gathered", _boom)
    with torch.no_grad():
        c = wt.rnnt_loss(xs, *args, compact=True)
    np.testing.assert_allclose(c.numpy(), with_grad.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_input_dtype_is_kept(dtype):
    case, _ = _case("generic ragged")
    xs = torch.log_softmax(case["xs"], -1)
    args = (case["ys"], case["xn"], case["yn"])
    ref = xs.clone().requires_grad_()
    wt.rnnt_loss(ref, *args, compact=True, reduction="sum").backward()
    x = xs.to(dtype).requires_grad_()
    out = wt.rnnt_loss(x, *args, compact=True, reduction="sum")
    out.backward()
    assert out.dtype == torch.float32 and x.grad.dtype == dtype
    tol = 1e-5 if dtype == torch.float64 else 2e-2
    np.testing.assert_allclose(x.grad.float().numpy(), ref.grad.numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("case_name,match", [
    ("max_frames", "max_frames=8 is below max"),
    ("max_labels", "max_labels=2 is below max"),
    ("rows", "fewer than sum"),
    ("ys_short", "compact labels has"),
    ("label_range", "labels outside"),
    ("ndim", "compact log_probs must have 2 dimensions"),
    ("ys_ndim", "compact labels must have 1 dimension"),
    ("blank", "compact mode needs blank"),
])
def test_compact_validation(case_name, match):
    case, _ = _case("generic ragged")
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    kw = {}
    if case_name == "max_frames":
        kw["max_frames"] = 8
    elif case_name == "max_labels":
        kw["max_labels"] = 2
    elif case_name == "rows":
        xs = xs[:-1].contiguous()
    elif case_name == "ys_short":
        ys = ys[:-1].contiguous()
    elif case_name == "label_range":
        ys = ys.clone()
        ys[0] = xs.shape[1]
    elif case_name == "ndim":
        xs = xs[None]
    elif case_name == "ys_ndim":
        ys = ys[None]
    else:
        kw["blank"] = -1
    with pytest.raises(ValueError, match=match):
        wt.rnnt_loss(xs, ys, xn, yn, compact=True, **kw)


@pytest.mark.parametrize("case_name,match", [
    ("loc_shape", "loc_rows must have shape"),
    ("loc_dtype", "loc_rows must be torch.int32"),
    ("blank", "outside"),
    ("device", "unsupported device"),
    ("ys_dtype", "ys must be 1-D torch.int32"),
    ("pref_shape", "pref must be"),
    ("ct_shape", "ct must be"),
])
def test_kernel_wrapper_checks_raise(case_name, match):
    """The gather's checks (blank, ys), the scatter's (loc, pref, ct) and
    the CUDA-only device check."""
    case, _ = _case("generic ragged")
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    blank, T, U = case["blank"], case["T"], case["U"]
    _, loc, pref = pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
    ct = case["ct"]
    if case_name == "loc_shape":
        loc = loc[:, :-1]
    elif case_name == "loc_dtype":
        loc = loc.long()
    elif case_name == "blank":
        blank = xs.shape[1]
    elif case_name == "ys_dtype":
        ys = ys.long()
    elif case_name == "pref_shape":
        pref = pref[:1]
    elif case_name == "ct_shape":
        ct = ct[..., 0]
    with pytest.raises(ValueError, match=match):
        if case_name == "device":
            pk._kernel_ready((("xs", xs),), xs.device)
        if case_name in ("blank", "ys_dtype"):
            pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
        pk.packed_scatter(ct, loc, pref, xn, yn, blank, xs.shape[0],
                          xs.shape[1], xs.dtype)


# ---- on the card: kernels against their plain versions --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", [*packed_cases.CASES, "NaN rule"])
def test_packed_kernels_match_plain_on_card(cuda_device, name):
    """The comparison `chip_smoke.py` makes: the gather's lattice, loc and
    prefix sums and the scatter from them, bit for bit, in every dtype and
    under the NaN rule."""
    if name == "NaN rule":
        case = packed_cases.nan_case(cuda_device)
    else:
        xn, yn, V, pad, blank, dtype = packed_cases.CASES[name]
        case = packed_cases.make_case(xn, yn, V, pad, blank, dtype, 0,
                                      cuda_device)
    packed_cases.compare(pk, case)
    torch.cuda.synchronize()


def _device_kernels(fn):
    """The names of the CUDA kernels ``fn()`` launches, by the profiler.
    The session opens with `profile_loss`'s pad of spin kernels, left out
    of the names: kineto can drop a session's first records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from warp_rnnt_tpu_torch.benchmarks.profile_loss import (
        PAD_KERNEL,
        pad_session,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_session()
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not ev.name.startswith(("Memcpy", "Memset"))
            and PAD_KERNEL not in ev.name]


@pytest.mark.cuda
def test_packed_gather_is_two_launches_a_call(cuda_device):
    """The compact forward from (xs, ys, xn, yn) to the lattice is one host
    call that launches two kernels, the prefix scan and the gather, and
    counts both; the backward one scatter kernel.  Two calls give the same
    bits."""
    case = packed_cases.full_case(4, 40, 12, 50, device=cuda_device)
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    T, U = case["T"], case["U"]
    before = dict(pk.LAUNCHES)
    names = _device_kernels(
        lambda: pk.packed_gather_lattice(xs, ys, xn, yn, 0, T, U))
    assert len(names) == 2, names
    assert "prefix_kernel" in names[0] and "lattice_gather_kernel" in names[1]
    assert pk.LAUNCHES["packed_gather"] - before["packed_gather"] == 2
    _, loc, pref = pk.packed_gather_lattice(xs, ys, xn, yn, 0, T, U)
    names = _device_kernels(lambda: pk.packed_scatter(
        case["ct"], loc, pref, xn, yn, 0, xs.shape[0], xs.shape[1]))
    assert len(names) == 1 and "packed_scatter_kernel" in names[0], names
    before = dict(pk.LAUNCHES)
    outs = []
    for _ in range(2):
        x = xs.detach().requires_grad_()
        lat = pk.packed_lattice(x, ys, xn, yn, 0, T, U)
        (lat * case["ct"]).sum().backward()
        outs.append((lat.detach(), x.grad))
    torch.cuda.synchronize()
    assert pk.LAUNCHES["packed_gather"] - before["packed_gather"] == 4
    assert pk.LAUNCHES["packed_scatter"] - before["packed_scatter"] == 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_compact_loss_on_card_matches_cpu(cuda_device):
    """The kernels' compact loss and packed gradient on the card against the
    plain composition on the CPU."""
    case, _ = _case("V=50", seed=7)
    xs = torch.log_softmax(case["xs"], -1)
    args = (case["ys"], case["xn"], case["yn"])
    out = []
    for dev in ("cpu", cuda_device):
        x = xs.detach().to(dev).requires_grad_()
        c = wt.rnnt_loss(x, *(a.to(dev) for a in args), compact=True)
        c.sum().backward()
        out.append((c.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_with_internals_on_card_matches_cpu(cuda_device):
    """`rnnt_loss_compact_with_internals` through the kernels on the card
    against the plain versions on the CPU, pad rows included."""
    case, _ = _case("pad rows", seed=8)
    xs = torch.log_softmax(case["xs"], -1)
    args = (case["ys"], case["xn"], case["yn"])
    want = compact.rnnt_loss_compact_with_internals(xs, *args)
    got = compact.rnnt_loss_compact_with_internals(
        xs.to(cuda_device), *(a.to(cuda_device) for a in args))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-4, atol=1e-5)
    assert torch.equal(got[2].cpu(), want[2])
