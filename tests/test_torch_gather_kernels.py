"""Parity of the port's column gathers (`warp_rnnt_tpu_torch/ops/gather_kernels.py`)
with the JAX package's gather experiments, `scripts/exp_colgather.py` and
`scripts/exp_pallas_gather.py`, whose Pallas kernels run here in interpret
mode.  The scripts are loaded from their paths, unedited.

On the CPU the wrappers run their plain torch versions, so these tests hold
the plain versions against the JAX functions.  The main path's lattice
(`gather_lattice`, and `functional.gather`'s CPU route) is held against the
JAX package's own main-path gather (`warp_rnnt_tpu/functional/gather.py`),
in fp32 and bf16, 4-D and flat, exactly and in the input's dtype.  Both only move values (and
widen them to fp32), so the tolerance is exact.  Where the two TPU kernels
read outside the row or the buffer, the JAX result is not a value of the
function, and those inputs are left out of the comparison (each test says
which); the port gives 0 there, held against a numpy gather instead.

The kernel-against-plain-version tests need the card, are marked `cuda`, and
share their cases and comparison with `chip_smoke.py`
(`warp_rnnt_tpu_torch/benchmarks/gather_cases.py`).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu.functional import gather as jax_gather
from warp_rnnt_tpu_torch.benchmarks import exp_gather, gather_cases
from warp_rnnt_tpu_torch.functional import gather as port_gather
from warp_rnnt_tpu_torch.ops import flat_kernels
from warp_rnnt_tpu_torch.ops import gather_kernels as gk

_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


colgather = _load("exp_colgather")
pgather = _load("exp_pallas_gather")

# (N, T, U, V, blank): T not a multiple of 8, V not a multiple of 128,
# blank != 0, U = 40 (2U = 80 columns, more than one JAX call's 64)
SHAPES = {
    "T=13": (2, 13, 4, 300, 0),
    "blank=3": (2, 13, 4, 300, 3),
    "U=40": (2, 9, 40, 300, 1),
}


def _labels(rng, N, U, V, blank):
    """(N, U) int32 labels other than the blank, the blank on the last row
    (lab == blank there), as the loss builds labels_ext."""
    lab = rng.randint(0, V - 1, (N, U))
    lab = np.where(lab >= blank, lab + 1, lab)
    lab[:, -1] = blank
    return lab.astype(np.int32)


def _inputs(name, seed=0):
    N, T, U, V, blank = SHAPES[name]
    rng = np.random.RandomState(seed)
    xs = rng.randn(N, T, U, V).astype(np.float32)
    return xs, _labels(rng, N, U, V, blank), blank, rng


def _np_gather(xs, lab, blank):
    """numpy blank/label channels (N, T, U) of xs (N, T, U, V); 0 where the
    label is outside [0, V)."""
    N, T, U, V = xs.shape
    ok = (lab >= 0) & (lab < V)
    idx = np.broadcast_to(np.where(ok, lab, 0)[:, None, :, None], (N, T, U, 1))
    got = np.take_along_axis(xs, idx, -1)[..., 0]
    return xs[..., blank], np.where(ok[:, None, :], got, 0).astype(xs.dtype)


@pytest.mark.parametrize("name, dtype", [
    ("T=13", "float32"), ("T=13", "bfloat16"), ("blank=3", "float32"),
    ("U=40", "float32")])
def test_gather_columns_flat_matches_jax(name, dtype):
    """gather_columns_flat on the blank/label columns against JAX's (one
    call for K <= 64, two for U=40).  In interpret mode JAX's window copy
    that runs past the buffer is clamped back inside it, so a column in the
    last partial 128-lane window reads the wrong lane there (on the TPU it
    reads lane padding): the columns stay below C // 128 * 128, which the
    blank last row keeps true here."""
    xs, lab, blank, _ = _inputs(name)
    N, T, U, V = xs.shape
    xs3 = xs.reshape(N, T, U * V)
    cols = gk.blank_label_cols(torch.tensor(lab), blank, V)
    assert int(cols.max()) < (U * V) // 128 * 128
    got = gk.gather_columns_flat(torch.tensor(xs3).to(getattr(torch, dtype)),
                                 cols)
    want = colgather.gather_columns_flat(
        jnp.asarray(xs3).astype(dtype), jnp.asarray(cols.numpy()))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, T, 2 * U)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_gather_fwd_matches_jax(name):
    """gather_fwd against the streaming kernel (`gather_fwd_pallas`).  Its
    masked sum gives 0 for a label at -1 or past its padded V block, and
    both are in the inputs; a label in [V, round_up(V, 128)) would sum the
    block's padding, so none is."""
    xs, lab, blank, _ = _inputs(name)
    lab[0, 0], lab[-1, 1] = -1, 10**6
    got = gk.gather_fwd(torch.tensor(xs), torch.tensor(lab), blank)
    want = pgather.gather_fwd_pallas(jnp.asarray(xs), jnp.asarray(lab), blank)
    for g, w, ref in zip(got, want, _np_gather(xs, lab, blank)):
        assert g.dtype == torch.float32 and g.shape == xs.shape[:3]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), ref)
    assert not got[1][0, :, 0].any() and not got[1][-1, :, 1].any()


@pytest.mark.parametrize("name", list(SHAPES))
def test_gather_fwd_sparse_matches_jax(name):
    """gather_fwd_sparse against the sparse-window kernel, both laid out
    (N, U, T).  That kernel reads the neighbouring row's entry for a label
    outside [0, V), so every label here is inside."""
    xs, lab, blank, _ = _inputs(name)
    N, T, U, V = xs.shape
    xs3 = xs.reshape(N, T, U * V)
    got = gk.gather_fwd_sparse(torch.tensor(xs3), torch.tensor(lab), blank, V)
    want = pgather.gather_fwd_sparse(jnp.asarray(xs3), jnp.asarray(lab), blank, V)
    for g, w, ref in zip(got, want, _np_gather(xs, lab, blank)):
        assert g.dtype == torch.float32 and g.shape == (N, U, T)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), ref.transpose(0, 2, 1))


@pytest.mark.parametrize("name", list(SHAPES))
def test_scatter_bwd_matches_jax(name):
    """scatter_bwd against `scatter_bwd_pallas`: ct_b at the blank, ct_l at
    the label, their sum where lab == blank (the last row), only the blank
    term for a label outside [0, V) (both give that)."""
    xs, lab, blank, rng = _inputs(name)
    N, T, U, V = xs.shape
    lab[0, 0], lab[-1, 1] = -1, V
    ct_b = rng.randn(N, T, U).astype(np.float32)
    ct_l = rng.randn(N, T, U).astype(np.float32)
    got = gk.scatter_bwd(torch.tensor(ct_b), torch.tensor(ct_l),
                         torch.tensor(lab), blank, V)
    want = pgather.scatter_bwd_pallas(jnp.asarray(ct_b), jnp.asarray(ct_l),
                                      jnp.asarray(lab), blank, V)
    assert got.dtype == torch.float32 and got.shape == (N, T, U, V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :, -1, blank].numpy(),
                                  ct_b[:, :, -1] + ct_l[:, :, -1])


@pytest.mark.parametrize("name", list(gather_cases.CASES))
def test_plain_versions_match_numpy(name):
    """The shared cases on the CPU: every wrapper (its plain version here)
    against a numpy gather, 0 for a column outside [0, C) or a label
    outside [0, V); `gather_cases.compare` runs too (the plain versions
    against themselves on the CPU)."""
    N, T, U, V, blank, dtype, K = gather_cases.CASES[name]
    case = gather_cases.make_case(N, T, U, V, blank, dtype, K, device="cpu")
    xs = case["xs"].double().numpy()
    cols, lab = case["cols"].numpy(), case["labels_ext"].numpy()
    C = U * V
    xs3 = xs.reshape(N, T, C)
    ok = (cols >= 0) & (cols < C)
    want = np.stack([xs3[n][:, np.where(ok[n], cols[n], 0)] for n in range(N)])
    want = np.where(ok[:, None, :], want, 0)
    got = gk.gather_columns_flat(case["xs3"], case["cols"])
    assert got.dtype == dtype and got.shape == (N, T, K)
    np.testing.assert_array_equal(got.double().numpy(), want)
    assert ((cols < 0) | (cols >= C)).any() and (cols == C - 1).any()

    b, e = _np_gather(xs, lab, blank)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    got_b, got_e = gk.gather_fwd(case["xs"], case["labels_ext"], blank)
    np.testing.assert_array_equal(got_b.numpy(), f32(b))
    np.testing.assert_array_equal(got_e.numpy(), f32(e))
    got_b, got_e = gk.gather_fwd_sparse(case["xs3"], case["labels_ext"], blank, V)
    np.testing.assert_array_equal(got_b.numpy(), f32(b).transpose(0, 2, 1))
    np.testing.assert_array_equal(got_e.numpy(), f32(e).transpose(0, 2, 1))
    assert ((lab < 0) | (lab >= V)).any() and (lab[:, -1] == blank).all()

    errs = gather_cases.compare(gk, case)
    assert set(errs) == set(gk.LAUNCHES) | {"flat_write"}


@pytest.mark.parametrize("V", [300, 3100])  # JAX's mask and take forms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_lattice_matches_jax_main_path_gather(layout, dtype, V):
    """The main path's (N, T, U, 2) lattice: the port's CPU route
    (`gather_blank_label_plain`, through the autograd Function) and
    `gather_lattice`'s plain version against JAX's `gather_blank_label` /
    `gather_blank_label_flat`, exactly, in the input's dtype."""
    rng = np.random.RandomState(5)
    N, T, U, blank = 2, 5, 4, 2
    xs = rng.randn(N, T, U, V).astype(np.float32)
    lab = _labels(rng, N, U, V, blank)
    loc = np.broadcast_to(lab[:, None, :], (N, T, U))
    jxs = jnp.asarray(xs).astype(dtype)
    txs = torch.tensor(xs).to(getattr(torch, dtype))
    tlab = torch.tensor(lab)
    if layout == "4d":
        want = jax_gather.gather_blank_label(jxs, jnp.asarray(loc), blank)
        got = port_gather.gather_blank_label(txs, tlab, blank)
    else:
        want = jax_gather.gather_blank_label_flat(
            jxs.reshape(N, T, U * V), jnp.asarray(loc), blank, V)
        got = port_gather.gather_blank_label_flat(txs.view(N, T, U * V), tlab,
                                                  blank, V)
    assert got.dtype == txs.dtype and got.shape == (N, T, U, 2)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        gk.gather_lattice(txs, tlab, blank).float().numpy(), want)


def test_main_path_forward_route(monkeypatch):
    """On a CPU tensor the loss's gather runs the plain formulation and
    never the kernel's wrapper (which the card takes, with no fallback);
    its gradient is the dense write, unchanged."""
    def _boom(*a, **k):
        raise AssertionError("kernel wrapper called on the CPU")

    monkeypatch.setattr(gk, "gather_lattice", _boom)
    rng = np.random.RandomState(6)
    xs = torch.tensor(rng.randn(2, 4, 3, 6).astype(np.float32),
                      requires_grad=True)
    lab = torch.tensor([[1, 5, 0], [2, 3, 0]], dtype=torch.int32)
    out = port_gather.gather_blank_label(xs, lab, 0)
    assert torch.equal(out, port_gather.gather_blank_label_plain(xs, lab, 0))
    ct = torch.tensor(rng.randn(2, 4, 3, 2).astype(np.float32))
    out.backward(ct)
    want = torch.zeros(2, 4, 3, 6)
    want[..., 0] += ct[..., 0]
    want.scatter_add_(3, lab.long()[:, None, :, None].expand(2, 4, 3, 1),
                      ct[..., 1:])
    assert torch.equal(xs.grad, want)


def test_out_of_range_labels_give_zero_not_a_neighbour():
    """A label of V would be the next row's blank entry in the flat view,
    and -1 the previous row's last entry; both give 0 here."""
    rng = np.random.RandomState(1)
    N, T, U, V = 1, 3, 3, 5
    xs = torch.tensor(rng.randn(N, T, U, V).astype(np.float32))
    lab = torch.tensor([[V, -1, 0]], dtype=torch.int32)
    _, e = gk.gather_fwd(xs, lab, 0)  # (N, T, U)
    assert not e[..., :2].any() and torch.equal(e[..., 2], xs[:, :, 2, 0])
    _, e = gk.gather_fwd_sparse(xs.view(N, T, U * V), lab, 0, V)  # (N, U, T)
    assert not e[:, :2].any() and torch.equal(e[:, 2], xs[:, :, 2, 0])
    e = gk.gather_lattice(xs, lab, 0)[..., 1]  # (N, T, U)
    assert not e[..., :2].any() and torch.equal(e[..., 2], xs[:, :, 2, 0])
    cols = torch.tensor([[U * V, -1, 0]], dtype=torch.int32)
    got = gk.gather_columns_flat(xs.view(N, T, U * V), cols)
    assert not got[..., :2].any() and torch.equal(got[..., 2], xs[:, :, 0, 0])


@pytest.mark.parametrize("call, match", [
    (lambda: gk.gather_columns_flat(torch.zeros(2, 3, 8),
                                    torch.zeros(2, 4, dtype=torch.int64)),
     "torch.int32"),
    (lambda: gk.gather_columns_flat(torch.zeros(2, 3, 8),
                                    torch.zeros(3, 4, dtype=torch.int32)),
     r"shape \(2, 4\)"),
    (lambda: gk.gather_columns_flat(torch.zeros(2, 3, 8, dtype=torch.int32),
                                    torch.zeros(2, 4, dtype=torch.int32)),
     "float tensor"),
    (lambda: gk.gather_fwd(torch.zeros(2, 3, 4, 5),
                           torch.zeros(2, 4, dtype=torch.int32), 5),
     "blank=5"),
    (lambda: gk.gather_fwd(torch.zeros(2, 3, 4, 5),
                           torch.zeros(2, 3, dtype=torch.int32), 0),
     r"shape \(2, 3\)|U\*V"),
    (lambda: gk.gather_fwd_sparse(torch.zeros(2, 3, 20),
                                  torch.zeros(2, 4, dtype=torch.int32), 0, 6),
     r"U\*V"),
    (lambda: gk.gather_fwd_sparse(torch.zeros(2, 3, 4, 5),
                                  torch.zeros(2, 4, dtype=torch.int32), 0, 5),
     "3-D"),
    (lambda: gk.gather_lattice(torch.zeros(2, 3, 4, 5),
                               torch.zeros(2, 4, dtype=torch.int32), -1),
     "blank=-1"),
    (lambda: gk.gather_lattice(torch.zeros(2, 3, 4, 5),
                               torch.zeros(2, 3, dtype=torch.int32), 0),
     r"shape \(2, 3\)|U\*V"),
    (lambda: gk.gather_lattice(torch.zeros(2, 3, 4, 5, device="meta"),
                               torch.zeros(2, 4, dtype=torch.int32), 0),
     "unsupported device"),
])
def test_wrappers_reject_what_the_kernel_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("name", list(gather_cases.CASES))
def test_launch_checks_take_what_the_plain_versions_take(name):
    """The one-expression check a CUDA launch passes (`_ready`, device
    aside) accepts every shared case and gives the columns the kernel
    gathers a frame: K for explicit columns, 2U for the blank/label
    layouts (labels_ext is (N, U)); a mismatched index is refused."""
    case = gather_cases.make_case(*gather_cases.CASES[name], device="cpu")
    xs, xs3, lab = case["xs"], case["xs3"], case["labels_ext"]
    blank, V = case["blank"], case["V"]
    N, _, U, _ = xs.shape
    cols = case["cols"]
    assert gk._ready(xs3, cols, gk._COLUMNS) == (cols.shape[1], -1)
    for layout, x in ((gk._LATTICE, xs), (gk._PLANAR_TU, xs),
                      (gk._PLANAR_UT, xs3)):
        assert gk._ready(x, lab, layout, blank, V) == (2 * U, -1)
        with pytest.raises(ValueError):
            gk._ready(x, lab[:, :-1], layout, blank, V)
        with pytest.raises(ValueError):
            gk._ready(x, lab[:1] if N > 1 else lab.repeat(2, 1), layout,
                      blank, V)
    with pytest.raises(ValueError, match="3-D"):
        gk._ready(xs, lab, gk._PLANAR_UT, blank, V)


def test_exp_gather_on_cpu(capsys):
    """`exp_gather` runs every variant at N=1 on the CPU, each held
    against the plain gather (it raises otherwise); no time on the CPU."""
    exp_gather.main(["all", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(exp_gather.VARIANTS)
    assert all("ms not measured (cpu)" in ln for ln in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(gather_cases.CASES))
def test_gather_kernels_match_plain_on_card(cuda_device, name):
    """Each kernel against its plain version on the card, exact."""
    N, T, U, V, blank, dtype, K = gather_cases.CASES[name]
    case = gather_cases.make_case(N, T, U, V, blank, dtype, K,
                                  device=cuda_device)
    before = dict(gk.LAUNCHES)
    gather_cases.compare(gk, case)
    torch.cuda.synchronize()
    assert all(gk.LAUNCHES[k] == before[k] + 1 for k in gk.LAUNCHES)


@pytest.mark.cuda
def test_gather_wrappers_raise_on_card(cuda_device):
    """On a CUDA tensor a wrapper launches or raises: a strided input is
    refused, not copied or sent to the plain version."""
    xs = torch.zeros(2, 3, 16, device=cuda_device)[:, :, ::2]
    cols = torch.zeros(2, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gather_columns_flat(xs, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(gather_cases.CASES))
def test_lattice_kernel_matches_main_path_plain_on_card(cuda_device, name):
    """The lattice kernel against the main path's plain formulation
    (`torch.gather` and a stack) on the card, exact, in xs's dtype."""
    case = gather_cases.make_case(*gather_cases.CASES[name], device=cuda_device)
    gather_cases.main_path_lattice(gk, port_gather.gather_blank_label_plain,
                                   case)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_main_path_gathers_through_the_kernel_on_card(cuda_device, layout):
    """`rnnt_loss` on the card launches the lattice kernel once a call, and
    gives the costs and gradient of the plain formulation bit for bit."""
    rng = np.random.RandomState(7)
    N, T, U, V = 3, 9, 5, 40
    xs = torch.log_softmax(torch.tensor(rng.randn(N, T, U, V)), -1).float()
    ys = torch.tensor(rng.randint(1, V, (N, U - 1)), dtype=torch.int32)
    xn = torch.tensor([9, 4, 7], dtype=torch.int32)
    yn = torch.tensor([4, 2, 3], dtype=torch.int32)
    shape = (N, T, U * V) if layout == "flat" else (N, T, U, V)
    x = xs.to(cuda_device).view(shape).requires_grad_()
    args = (ys.to(cuda_device), xn.to(cuda_device), yn.to(cuda_device))
    before = gk.LAUNCHES["gather_lattice"]
    costs = wt.rnnt_loss(x, *args)
    costs.sum().backward()
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gather_lattice"] == before + 1
    lab = torch.cat([args[0], torch.zeros(N, 1, dtype=torch.int32,
                                          device=cuda_device)], 1)
    lat = port_gather.gather_blank_label_plain(
        x.detach().view(N, T, U, V), lab, 0).requires_grad_()
    ref = wt.rnnt_loss(lat, args[0], args[1], args[2], blank=-1)
    ref.sum().backward()
    assert torch.equal(costs.detach(), ref.detach())
    d = flat_kernels.flat_grad_write(
        lat.grad[..., 0].contiguous(), lat.grad[..., 1].contiguous(), lab, 0,
        V, U * V)
    assert torch.equal(x.grad.reshape(-1), d.reshape(-1))
