"""Parity of the PyTorch port's `rnnt_loss_joint` (the layout dispatcher)
with the JAX package, on the CPU.

The same seeded numpy inputs (those of `tests/test_joint_loss.py`) go
through JAX's `rnnt_loss_joint` and the port's, layout by layout, in "add"
and "concat":
  * each layout against JAX's same layout: costs rtol 2e-3 and each
    gradient (f, g and the four parameters) within 2e-2 of its largest
    entry.  Both joints round h, or the pre-activations and logits, to
    bf16; JAX's and torch's fp32 tanh differ in the last bit now and then
    and flip a rounding (`tests/test_torch_fused_joint.py` `_flip_bound`),
    hence the tolerance of `test_fused_joint.py:161-165`;
  * the port's layouts against each other, with the tolerances of
    `tests/test_joint_loss.py` (costs rtol 2e-3, gradients rtol 5e-2,
    atol 5e-3);
  * ``compute_dtype=torch.float32`` against JAX's fp32 program (rtol 1e-5);
  * `pack_joint_metadata` equal to JAX's; "auto" on the CPU is "padded";
    the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device, tt  # noqa: F401  (fixture)
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu.functional import joint_loss as jjl
from warp_rnnt_tpu_torch.functional import joint_loss

LAYOUTS = ("padded", "compact", "fused")


def _setup(mode="add", seed=0):
    """Inputs of `tests/test_joint_loss._setup`, as numpy."""
    rng = np.random.RandomState(seed)
    N, T, U1, F, H, V = 3, 10, 4, 6, 16, 33
    f = rng.randn(N, T, F).astype(np.float32) * 0.4
    g = rng.randn(N, U1, F).astype(np.float32) * 0.4
    fin = 2 * F if mode == "concat" else F
    params = dict(w_pre=rng.randn(fin, H).astype(np.float32) * 0.3,
                  b_pre=rng.randn(H).astype(np.float32) * 0.1,
                  w_out=rng.randn(H, V).astype(np.float32) * 0.3,
                  b_out=rng.randn(V).astype(np.float32) * 0.1)
    ys = rng.randint(1, V, (N, U1 - 1)).astype(np.int32)
    xn = np.array([10, 7, 4], np.int32)
    yn = np.array([3, 1, 0], np.int32)
    return f, g, params, ys, xn, yn


def _port(inputs, device="cpu", **kw):
    """(costs, {name: grad}) of the port under a weighted-sum cotangent."""
    f, g, params, ys, xn, yn = inputs
    w = torch.tensor([0.7, 1.3, 0.4], device=device)
    ft = torch.tensor(f, device=device, requires_grad=True)
    gt = torch.tensor(g, device=device, requires_grad=True)
    pt = {k: torch.tensor(v, device=device, requires_grad=True)
          for k, v in params.items()}
    out = wt.rnnt_loss_joint(ft, gt, pt, *(x.to(device) for x in tt(ys, xn, yn)),
                             **kw)
    (out * w).sum().backward()
    grads = {"f": ft.grad, "g": gt.grad, **{k: v.grad for k, v in pt.items()}}
    return out.detach().cpu().numpy(), {k: v.cpu().numpy()
                                        for k, v in grads.items()}


def _jax(inputs, **kw):
    f, g, params, ys, xn, yn = inputs
    w = np.array([0.7, 1.3, 0.4], np.float32)

    def loss(f, g, p):
        o = warp_rnnt_tpu.rnnt_loss_joint(f, g, p, jnp.asarray(ys), xn, yn,
                                          impl="scan", **kw)
        return (o * w).sum(), o

    (_, out), (gf, gg, gp) = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                has_aux=True)(
        jnp.asarray(f), jnp.asarray(g),
        {k: jnp.asarray(v) for k, v in params.items()})
    grads = {"f": gf, "g": gg, **gp}
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _close_grads(got, want, rel_atol, rtol, what):
    for name, w in want.items():
        g = got[name]
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=max(rel_atol * np.abs(w).max(), 1e-6),
            err_msg=f"{what} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", ["add", "concat"])
def test_layout_matches_jax(mode, layout):
    inputs = _setup(mode)
    costs, grads = _port(inputs, mode=mode, layout=layout)
    jcosts, jgrads = _jax(inputs, mode=mode, layout=layout)
    np.testing.assert_allclose(costs, jcosts, rtol=2e-3)
    _close_grads(grads, jgrads, 2e-2, 0.0, layout)


@pytest.mark.parametrize("mode", ["add", "concat"])
def test_all_layouts_agree(mode):
    inputs = _setup(mode, seed=1)
    out = {layout: _port(inputs, mode=mode, layout=layout)
           for layout in LAYOUTS}
    for layout in ("compact", "fused"):
        np.testing.assert_allclose(out[layout][0], out["padded"][0],
                                   rtol=2e-3, atol=2e-3, err_msg=layout)
        for name, want in out["padded"][1].items():
            np.testing.assert_allclose(out[layout][1][name], want, rtol=5e-2,
                                       atol=5e-3, err_msg=f"{layout} {name}")


def test_auto_route_on_cpu_is_padded():
    inputs = _setup()
    assert joint_loss.joint_layout_route(10, 4, 16, 33, platform="cpu") == "padded"
    assert joint_loss.joint_layout_route(10, 4, 16, 4096, platform="cpu") == "padded"
    if not torch.cuda.is_available():
        assert joint_loss.joint_layout_route(10, 4, 16, 4096) == "padded"
    auto = _port(inputs, layout="auto")
    padded = _port(inputs, layout="padded")
    np.testing.assert_array_equal(auto[0], padded[0])
    for name in padded[1]:
        np.testing.assert_array_equal(auto[1][name], padded[1][name])


@pytest.mark.parametrize("xn,yn", [((3, 2), (1, 0)), ((7, 1, 5, 4), (3, 0, 6, 2))])
def test_pack_joint_metadata_matches_jax(xn, yn):
    xn, yn = np.array(xn, np.int32), np.array(yn, np.int32)
    got = joint_loss.pack_joint_metadata(*tt(xn, yn))
    want = jjl.pack_joint_metadata(xn, yn)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_route_on_cuda_takes_fused_from_the_measured_v():
    """On a CUDA device "auto" takes "fused" from `_CUDA_FUSED_MIN_V` (5000)
    at joint widths up to `_CUDA_FUSED_MAX_H` (512), both from the H100
    readings beside them, and "padded" elsewhere; T, U and N do not move
    the answer."""
    route = joint_loss.joint_layout_route
    assert joint_loss._CUDA_FUSED_MIN_V == 5000
    assert joint_loss._CUDA_FUSED_MAX_H == 512
    assert route(150, 41, 256, 28, N=16, platform="cuda") == "padded"
    assert route(150, 21, 256, 4999, N=16, platform="cuda") == "padded"
    assert route(150, 21, 256, 5000, N=16, platform="cuda") == "fused"
    assert route(150, 21, 256, 64000, N=2, platform="cuda") == "fused"
    assert route(10, 4, 200, 64000, N=1, platform="cuda") == "fused"
    assert route(150, 21, 257, 5000, N=16, platform="cuda") == "fused"
    assert route(150, 21, 512, 5000, N=16, platform="cuda") == "fused"
    assert route(150, 21, 513, 5000, N=16, platform="cuda") == "padded"
    assert route(150, 21, 640, 64000, N=2, platform="cuda") == "padded"


# The cells of `chip_smoke.py` `time_route_sweep` (T=150; V=28 with 40
# labels, else 20), each with the layout its readings beside
# `_CUDA_FUSED_MIN_V` / `_CUDA_FUSED_MAX_H` give on CUDA.
_ROUTE_CELLS = [(28, 256, 16, "padded"), (256, 256, 16, "padded"),
                (1000, 256, 16, "padded"), (5000, 256, 16, "fused"),
                (5000, 512, 16, "fused"), (5000, 640, 16, "padded"),
                (5000, 1024, 16, "padded"), (64000, 256, 2, "fused"),
                (64000, 512, 2, "fused"), (64000, 640, 2, "padded"),
                (64000, 1024, 2, "padded")]


@pytest.mark.parametrize("V,H,N,want", _ROUTE_CELLS)
def test_auto_route_at_each_measured_cell(V, H, N, want):
    """Each measured cell routes as the readings decided on CUDA (fused
    only where it won every reading at every measured V above, and at
    every H below: H=640 ties at V=5000 and loses at V=64000, so it stays
    padded at both); the CPU answer is "padded" everywhere, as in JAX."""
    U = 41 if V == 28 else 21
    route = joint_loss.joint_layout_route
    assert route(150, U, H, V, N=N, platform="cuda") == want
    assert route(150, U, H, V, N=N, platform="cpu") == "padded"


def test_compute_dtype_fp32():
    """fp32 joint numerics on the padded and compact layouts against JAX's
    fp32 program (rtol 1e-5, atol 1e-5, as `tests/test_joint_loss.py`);
    "auto" takes "padded"; "fused" raises."""
    inputs = _setup(seed=2)
    want, wgrads = _jax(inputs, layout="padded", compute_dtype=jnp.float32)
    for layout in ("padded", "compact", "auto"):
        got, grads = _port(inputs, layout=layout, compute_dtype=torch.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=layout)
        _close_grads(grads, wgrads, 1e-4, 1e-4, layout)
    f, g, params, ys, xn, yn = inputs
    with pytest.raises(ValueError, match="bf16"):
        wt.rnnt_loss_joint(*tt(f, g), {k: torch.tensor(v) for k, v in
                                       params.items()}, *tt(ys, xn, yn),
                           layout="fused", compute_dtype=torch.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reductions_and_average_frames(layout):
    f, g, params, ys, xn, yn = _setup()
    args = (*tt(f, g), {k: torch.tensor(v) for k, v in params.items()},
            *tt(ys, xn, yn))
    with torch.no_grad():
        none = wt.rnnt_loss_joint(*args, layout=layout)
        mean = wt.rnnt_loss_joint(*args, layout=layout, reduction="mean")
        af = wt.rnnt_loss_joint(*args, layout=layout, average_frames=True)
    np.testing.assert_allclose(float(mean), float(none.mean()), rtol=1e-6)
    np.testing.assert_allclose(af.numpy(), none.numpy() / xn, rtol=1e-6)


def test_unknown_layout_raises():
    f, g, params, ys, xn, yn = _setup()
    with pytest.raises(ValueError, match="unknown layout"):
        wt.rnnt_loss_joint(*tt(f, g), {k: torch.tensor(v) for k, v in
                                       params.items()}, *tt(ys, xn, yn),
                           layout="nope")


@pytest.mark.cuda
def test_layouts_on_card_match_cpu(cuda_device):
    """Each layout on the card (kernels) against the same layout on the CPU
    (plain versions): costs rtol 1e-3, gradients within 2e-2 of their
    largest entry (bf16 roundings of h may flip between the devices)."""
    inputs = _setup(seed=3)
    for layout in LAYOUTS:
        want, wgrads = _port(inputs, layout=layout)
        got, grads = _port(inputs, device=cuda_device, layout=layout)
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=layout)
        _close_grads(grads, wgrads, 2e-2, 0.0, layout)
