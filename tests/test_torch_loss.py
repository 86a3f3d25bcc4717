"""Parity of the PyTorch port's public loss with the JAX package, on the CPU.

`warp_rnnt_tpu_torch.rnnt_loss` and its gradient are held against
`warp_rnnt_tpu.rnnt_loss(impl="scan")` on the same seeded numpy inputs
(rtol = atol = 1e-5) for the 4-D, flat 3-D and pre-gathered (blank=-1)
inputs, every reduction, average_frames, FastEmit and ragged lengths; and
against the golden vectors of `tests/golden.py` (the tolerances of the
JAX package's own golden tests).  Also: a finite-difference check of the
gradient, the no-grad route, validation, and that neither the package nor
`chip_smoke.py` imports JAX or the JAX package.
"""

import ast
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from _torch_port_helpers import (  # noqa: F401  (cuda_device is a fixture)
    cuda_device,
    gathered,
    loss_inputs,
    tt,
)
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
import warp_rnnt_tpu_torch.functional.core as core
from warp_rnnt_tpu_torch.ops import cuda_impl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _layout_inputs(layout, xs, ys):
    """(log_probs numpy, labels, blank) for one input layout."""
    N, T, U, V = xs.shape
    if layout == "4d":
        return xs, ys, 0
    if layout == "flat":
        return xs.reshape(N, T, U * V), ys, 0
    blank, emit = gathered(xs, ys)
    return np.stack([blank, emit], axis=-1), ys, -1


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("layout", ["4d", "flat", "pregathered"])
def test_loss_and_grad_match_jax(layout, reduction):
    xs, ys, xn, yn = loss_inputs(10)
    lp, labels, blank = _layout_inputs(layout, xs, ys)
    w = np.random.RandomState(11).rand(xs.shape[0]).astype(np.float32)

    x = torch.tensor(lp, requires_grad=True)
    out = wt.rnnt_loss(x, *tt(labels, xn, yn), reduction=reduction, blank=blank,
                       gather=True)
    (out * torch.tensor(w) if reduction == "none" else out).sum().backward()

    def jloss(z):
        o = warp_rnnt_tpu.rnnt_loss(z, jnp.asarray(labels), xn, yn,
                                    reduction=reduction, blank=blank, impl="scan")
        return (o * w if reduction == "none" else o).sum(), o

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lp))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert x.grad.shape == x.shape
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("average_frames,fastemit", [(True, 0.0), (False, 0.3),
                                                     (True, 0.3)])
def test_options_match_jax(average_frames, fastemit):
    xs, ys, xn, yn = loss_inputs(12, N=3, T=9, U=4, V=6)
    kw = dict(average_frames=average_frames, fastemit_lambda=fastemit,
              reduction="mean")
    x = torch.tensor(xs, requires_grad=True)
    out = wt.rnnt_loss(x, *tt(ys, xn, yn), **kw)
    out.backward()
    jout, jgrad = jax.value_and_grad(
        lambda z: warp_rnnt_tpu.rnnt_loss(z, jnp.asarray(ys), xn, yn,
                                          impl="scan", **kw)
    )(jnp.asarray(xs))
    np.testing.assert_allclose(float(out.detach()), float(jout), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("impl", ["auto", "cuda"])  # CPU: scan, kernel twin
@pytest.mark.parametrize("name", sorted(golden.ALL_PADDED_CASES))
def test_golden(name, impl):
    case = golden.ALL_PADDED_CASES[name]
    x = torch.tensor(case["xs"], dtype=torch.float32, requires_grad=True)
    costs = wt.rnnt_loss(x, *tt(case["ys"], case["xn"], case["yn"]), impl=impl)
    costs.sum().backward()
    np.testing.assert_allclose(costs.detach().numpy(), case["expected_costs"],
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), case["expected_grads"],
                               rtol=1e-4, atol=2e-5)


def test_internals_match_jax():
    xs, ys, xn, yn = loss_inputs(13)
    got = wt.rnnt_loss_with_internals(*tt(xs, ys, xn, yn), fastemit_lambda=0.1,
                                      return_mismatch=True)
    want = warp_rnnt_tpu.rnnt_loss_with_internals(
        jnp.asarray(xs), jnp.asarray(ys), xn, yn, fastemit_lambda=0.1,
        impl="scan", return_mismatch=True,
    )
    for g, w in zip(got[:2], want[:2]):  # costs, grads (N, T, U, V)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    mask = np.isfinite(np.asarray(want[2]))
    for g, w in zip(got[2:4], want[2:4]):  # alphas, betas: valid cells
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask], **TOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_finite_difference_gradient():
    """Central differences on a 2x4x3x5 lattice in fp32: eps 1e-3, atol 2e-3
    (fp32 rounding of a cost near 5 over 2*eps is ~5e-4)."""
    xs, ys, xn, yn = loss_inputs(14, N=2, T=4, U=3, V=5)
    w = torch.tensor([0.7, 1.3])
    labels, xn_t, yn_t = tt(ys, xn, yn)

    def f(z):
        return float((wt.rnnt_loss(z, labels, xn_t, yn_t) * w).sum())

    x = torch.tensor(xs, requires_grad=True)
    (wt.rnnt_loss(x, labels, xn_t, yn_t) * w).sum().backward()
    fd = np.zeros_like(xs)
    eps = 1e-3
    with torch.no_grad():
        for i in np.ndindex(xs.shape):
            z = torch.tensor(xs)
            z[i] += eps
            hi = f(z)
            z[i] -= 2 * eps
            fd[i] = (hi - f(z)) / (2 * eps)
    np.testing.assert_allclose(x.grad.numpy(), fd, rtol=0, atol=2e-3)


def test_no_grad_route_runs_beta_only(monkeypatch):
    """Without a gradient the core runs the beta-only sweep, never the
    alpha+grads forward-backward; with one, it runs the latter."""
    def _boom(*a, **k):
        raise AssertionError("alpha+grads sweep ran")

    monkeypatch.setattr(core, "_forward_backward", _boom)
    case = golden.FORWARD_BATCH
    x = torch.tensor(case["xs"], dtype=torch.float32, requires_grad=True)
    args = tt(case["ys"], case["xn"], case["yn"])
    with torch.no_grad():
        c1 = wt.rnnt_loss(x, *args, impl="cuda")
    c2 = wt.rnnt_loss(x.detach(), *args)
    for c in (c1, c2):
        np.testing.assert_allclose(c.numpy(), case["expected_costs"],
                                   rtol=1e-4, atol=2e-5)
    with pytest.raises(AssertionError, match="sweep ran"):
        wt.rnnt_loss(x, *args)


def test_input_dtype_is_kept():
    """Other float dtypes are computed in fp32; the gradient comes back in
    the input dtype."""
    xs, ys, xn, yn = loss_inputs(15, N=2, T=5, U=3, V=6)
    ref = torch.tensor(xs, requires_grad=True)
    wt.rnnt_loss(ref, *tt(ys, xn, yn), reduction="sum").backward()
    for dtype, tol in ((torch.float64, 1e-5), (torch.bfloat16, 2e-2)):
        x = torch.tensor(xs).to(dtype).requires_grad_()
        out = wt.rnnt_loss(x, *tt(ys, xn, yn), reduction="sum")
        out.backward()
        assert out.dtype == torch.float32 and x.grad.dtype == dtype
        np.testing.assert_allclose(x.grad.float().numpy(), ref.grad.numpy(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("case,exc,match", [
    ("reduction", ValueError, "Unknown reduction method"),
    ("blank_type", ValueError, "blank must be an int"),
    ("average_frames", ValueError, "average_frames must be a bool"),
    ("ndim", ValueError, "log_probs must have 4 dimensions"),
    ("labels_shape", ValueError, "labels must have shape"),
    ("flat_divisible", ValueError, "is not divisible by U"),
    ("pregathered", ValueError, "blank=-1 expects pre-gathered"),
    ("contiguous", RuntimeError, "xs must be contiguous"),
    ("ys_dtype", RuntimeError, "ys must be a Int tensor"),
    ("xn_dtype", RuntimeError, "xn must be a Int tensor"),
    ("compact", ValueError, "compact log_probs must have 2 dimensions"),
    ("impl", ValueError, "unknown impl"),
])
def test_validation(case, exc, match):
    xs, ys, xn, yn = tt(*loss_inputs(16, N=2, T=3, U=3, V=4))
    kw = {}
    if case == "reduction":
        kw["reduction"] = "avg"
    elif case == "blank_type":
        kw["blank"] = 0.0
    elif case == "average_frames":
        kw["average_frames"] = 1
    elif case == "ndim":
        xs = xs[0, 0]
    elif case == "labels_shape":
        ys = ys[:, :1]
    elif case == "flat_divisible":
        xs = xs.reshape(2, 3, 12)[..., :11].contiguous()
    elif case == "pregathered":
        kw["blank"] = -1
    elif case == "contiguous":
        xs = xs.transpose(1, 2)
    elif case == "ys_dtype":
        ys = ys.long()
    elif case == "xn_dtype":
        xn = xn.long()
    elif case == "compact":
        kw["compact"] = True
    else:
        kw["impl"] = "pallas"
    with pytest.raises(exc, match=match):
        wt.rnnt_loss(xs, ys, xn, yn, **kw)


def test_import_loads_no_jax():
    """Importing the port loads neither jax nor warp_rnnt_tpu (a subprocess:
    this test process has imported jax already)."""
    code = (
        "import sys, warp_rnnt_tpu_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'warp_rnnt_tpu' or m.startswith('warp_rnnt_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_import_loads_no_tensorflow_and_binding_no_jax():
    """`import warp_rnnt_tpu_torch` loads no tensorflow (torch users need
    none), and the TF front end loads no warp_rnnt_tpu and no jax module
    beyond those `import tensorflow, torch` loads itself (TensorFlow may
    import jax on its own).  A subprocess each."""
    def loads(mod, banned, before=""):
        code = (
            f"import sys{before}\n"
            "pre = set(sys.modules)\n"
            f"import {mod}\n"
            f"bad = [m for m in set(sys.modules) - pre"
            f" if m.split('.')[0] in {banned!r}]\n"
            "assert not bad, bad\n"
        )
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                       timeout=300)

    loads("warp_rnnt_tpu_torch", ("tensorflow",))
    loads("warp_rnnt_tpu_torch.bindings", ("tensorflow",))
    pytest.importorskip("tensorflow")
    loads("warp_rnnt_tpu_torch.bindings.tf_binding",
          ("jax", "jaxlib", "warp_rnnt_tpu"), before=", tensorflow, torch")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_imports_in_port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "warp_rnnt_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "warp_rnnt_tpu"), (path, mod)


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    """No CUDA device (this machine), or no package beside the script: exit
    non-zero with no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["4d", "flat", "pregathered"])
def test_cuda_loss_matches_scan(cuda_device, layout):
    """On the card: the kernels' loss and gradient against the port's scan."""
    xs, ys, xn, yn = loss_inputs(17, N=4, T=40, U=6, V=130)
    lp, labels, blank = _layout_inputs(layout, xs, ys)
    args = [a.to(cuda_device) for a in tt(labels, xn, yn)]
    grads = []
    for impl in ("auto", "scan"):
        x = torch.tensor(lp, device=cuda_device, requires_grad=True)
        out = wt.rnnt_loss(x, *args, blank=blank, reduction="sum", impl=impl)
        out.backward()
        grads.append((out.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4, atol=1e-5)
    before = cuda_impl.LAUNCHES["lattice_beta_only"]
    with torch.no_grad():
        wt.rnnt_loss(torch.tensor(lp, device=cuda_device), *args, blank=blank)
    assert cuda_impl.LAUNCHES["lattice_beta_only"] == before + 1
