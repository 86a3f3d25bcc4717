"""Parity of the PyTorch port's fused joint + loss with the JAX package, on
the CPU.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels in interpret mode, as `tests/test_fused_joint.py` runs them) and the
port (the plain torch versions of the CUDA kernels):
  * the plain forward against `joint_lattice_fwd`: atol 1e-4 where the bf16
    roundings of h agree; where the two frameworks' fp32 tanh differ in a
    bit that flips one, the flip's own bound is added (`_flip_bound`);
  * `fused_joint_core` costs (rtol 1e-5) and d_a, d_c, d_w, d_b (the
    tolerance of `test_fused_joint.py:99-101`), ragged, with FastEmit;
  * `rnnt_loss_fused_joint` in both modes, every reduction, average_frames,
    loss and the gradients of f, g and the four parameters (the tolerances
    of `test_fused_joint.py:161-165`);
  * the port's `Joint` against Flax `Joint.apply` with the parameters
    carried across, within 2 bf16 ulps of the output's scale;
  * gradients exactly zero outside the lengths, the no-grad route, and the
    `ValueError`s;
  * the kernels' padding of H: `h_plan`'s widths, and the plain versions on
    `pad_h`'s operands giving the unpadded outputs (H=40); the wrapper
    against JAX at H=40 and H=640 (wider than one 512-column slice);
  * the comparison that holds the kernels to their plain versions
    (`benchmarks/fused_joint_cases.py`) rejects a backward with a dropped or
    mis-scaled softmax term.
Kernel-against-plain-version tests need the card and are marked `cuda`.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device, tt  # noqa: F401  (fixture)
import warp_rnnt_tpu_torch as wt
import warp_rnnt_tpu_torch.ops.fused_joint as fj
from warp_rnnt_tpu.ops import fused_joint as jfj
from warp_rnnt_tpu_torch.benchmarks import fused_joint_cases as cases
from warp_rnnt_tpu_torch.functional import rnnt_loss
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.models import Joint, carry_flax_joint

GRAD_TOL = dict(rtol=5e-2, rel_atol=2e-2)     # test_fused_joint.py:99-101
WRAPPER_TOL = dict(rtol=0.1, rel_atol=2e-2)   # test_fused_joint.py:161-165


def _setup(N=2, T=10, U=5, V=33, H=16, seed=0, ragged=True):
    """Inputs of `test_fused_joint._setup`, as numpy."""
    rng = np.random.RandomState(seed)
    a = rng.randn(N, T, H).astype(np.float32) * 0.3
    c = rng.randn(N, U, H).astype(np.float32) * 0.3
    w = rng.randn(H, V).astype(np.float32) * 0.2
    b = rng.randn(V).astype(np.float32) * 0.1
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = rng.randint(min(U, T), T + 1, size=N).astype(np.int32)
    yn = rng.randint(1, U, size=N).astype(np.int32)
    if not ragged:
        xn[:], yn[:] = T, U - 1
    return a, c, w, b, labels, xn, yn


def _close(got, want, rtol, rel_atol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=max(rel_atol * np.abs(want).max(), 1e-5),
        err_msg=name,
    )


def _valid_t(xn, T):
    return np.arange(T)[None, :] < xn[:, None]


def _flip_bound(a, c, w):
    """(N, T, U) bound on how far a logit moves where JAX's fp32 tanh and
    torch's differ in a bit that changes the bf16 rounding of h:
    sum_k |hb_jax - hb_torch|_k * max_v |W_bf16[k, v]|.  Zero where no
    rounding flips."""
    pre = a[:, :, None, :] + c[:, None, :, :]
    h_t = torch.tanh(torch.tensor(pre)).to(torch.bfloat16).float().numpy()
    h_j = np.asarray(jnp.tanh(jnp.asarray(pre)).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    w_max = np.abs(torch.tensor(w).to(torch.bfloat16).float().numpy()).max(1)
    return np.abs(h_j - h_t) @ w_max


def _assert_fwd_close(got, want, bound, mask=None):
    """atol 1e-4 where no bf16 rounding of h flips, plus the flip's bound
    where one does (rare: < 2 % of the cells)."""
    assert (bound > 0).mean() < 0.02
    for g, w_ in zip(got, want):
        g, w_ = g.numpy(), np.asarray(w_)
        if mask is not None:
            g, w_, b_ = g[mask], w_[mask], bound[mask]
        else:
            b_ = bound
        assert (np.abs(g - w_) <= 1e-4 + b_).all(), np.abs(g - w_).max()


@pytest.mark.parametrize("blank", [0, 3])
@pytest.mark.parametrize("shape", [(2, 10, 5, 33, 16), (1, 17, 9, 40, 24),
                                   (1, 41, 37, 29, 16)])
def test_plain_forward_matches_jax(shape, blank):
    a, c, w, b, labels, xn, yn = _setup(*shape, ragged=False)
    lab = np.concatenate([labels, np.full((shape[0], 1), blank, np.int32)], 1)
    got = fj.joint_lattice_fwd(*tt(a, c, w, b, lab, xn, yn), blank)
    want = jfj.joint_lattice_fwd(*map(jnp.asarray, (a, c, w, b, lab, xn, yn)),
                                 blank)
    _assert_fwd_close(got, want, _flip_bound(a, c, w))


def test_plain_forward_ragged_zeros_past_lengths():
    """Valid frames agree with JAX; frames t >= xn are exactly zero."""
    a, c, w, b, labels, xn, yn = _setup(N=3, T=12, U=4, V=21, seed=4)
    xn = np.array([12, 3, 7], np.int32)
    lab = np.concatenate([labels, np.zeros((3, 1), np.int32)], 1)
    got = fj.joint_lattice_fwd(*tt(a, c, w, b, lab, xn, yn), 0)
    want = jfj.joint_lattice_fwd(*map(jnp.asarray, (a, c, w, b, lab, xn, yn)), 0)
    live = _valid_t(xn, 12)
    _assert_fwd_close(got, want, _flip_bound(a, c, w), live)
    for g in got:
        assert (g.numpy()[~live] == 0.0).all()


def _core_both(a, c, w, b, labels, xn, yn, blank, fastemit, weights):
    """(costs, grads) of the port's and JAX's fused_joint_core under the
    weighted-sum cotangent."""
    at, ct, wt_, bt = (torch.tensor(x, requires_grad=True) for x in (a, c, w, b))
    costs = fj.fused_joint_core(at, ct, wt_, bt, *tt(labels, xn, yn), blank,
                                fastemit)
    (costs * torch.tensor(weights)).sum().backward()
    port = (costs.detach().numpy(), [x.grad.numpy() for x in (at, ct, wt_, bt)])

    def jloss(a, c, w, b):
        k = jfj.fused_joint_core(a, c, w, b, jnp.asarray(labels), jnp.asarray(xn),
                                 jnp.asarray(yn), blank, fastemit, "scan")
        return (k * weights).sum(), k

    (_, jc), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (a, c, w, b)))
    return port, (np.asarray(jc), [np.asarray(g) for g in jg])


@pytest.mark.parametrize("blank,fastemit", [(0, 0.0), (0, 0.3), (3, 0.1)])
def test_core_costs_and_grads_match_jax(blank, fastemit):
    a, c, w, b, labels, xn, yn = _setup(N=3, T=11, U=5, V=30, seed=5)
    labels[labels == blank] = 1
    weights = np.array([0.7, 1.3, 0.4], np.float32)
    (pc, pg), (jc, jg) = _core_both(a, c, w, b, labels, xn, yn, blank, fastemit,
                                    weights)
    np.testing.assert_allclose(pc, jc, rtol=1e-5)
    for name, g, w_ in zip(("d_a", "d_c", "d_w", "d_b"), pg, jg):
        _close(g, w_, **GRAD_TOL, name=name)


@pytest.mark.parametrize("V", [300, 257])
def test_plain_forward_matches_jax_v_blocked(monkeypatch, V):
    """The plain forward against JAX's `_fwd_kernel_vb` (running logsumexp
    over 128-column blocks, the vocabulary tail padded with bias -1e30)."""
    monkeypatch.setattr(jfj, "_FORCE_BV", 128)
    a, c, w, b, labels, xn, yn = _setup(N=2, T=9, U=5, V=V, H=16, seed=10,
                                        ragged=False)
    lab = np.concatenate([labels, np.zeros((2, 1), np.int32)], 1)
    got = fj.joint_lattice_fwd(*tt(a, c, w, b, lab, xn, yn), 0)
    want = jfj.joint_lattice_fwd(*map(jnp.asarray, (a, c, w, b, lab, xn, yn)), 0)
    _assert_fwd_close(got, want, _flip_bound(a, c, w))


def test_core_matches_jax_v_blocked_kernels(monkeypatch):
    """JAX's V-blocked kernels (`_fwd_kernel_vb`, `_bwd_dadc_kernel_vb`,
    `_bwd_dwdb_kernel_vb`, forced with BV=128 over V=300: three blocks, a
    padded tail) against the port's plain `fused_joint_core`, with the
    tolerances of the single-block test above.  The port has one route at
    every V: its kernels walk V in 64-column chunks."""
    monkeypatch.setattr(jfj, "_FORCE_BV", 128)
    assert jfj._select_bv(11, 5, 16, 300) == 128
    a, c, w, b, labels, xn, yn = _setup(N=2, T=11, U=5, V=300, H=16, seed=9)
    weights = np.array([0.8, 1.1], np.float32)
    (pc, pg), (jc, jg) = _core_both(a, c, w, b, labels, xn, yn, 0, 0.0, weights)
    np.testing.assert_allclose(pc, jc, rtol=1e-5)
    for name, g, w_ in zip(("d_a", "d_c", "d_w", "d_b"), pg, jg):
        _close(g, w_, **GRAD_TOL, name=name)


def _wrapper_inputs(mode, seed=3):
    rng = np.random.RandomState(seed)
    N, T, U, V, H, F, G = 2, 9, 4, 29, 16, 12, 12 if mode == "add" else 10
    f = rng.randn(N, T, F).astype(np.float32) * 0.4
    g = rng.randn(N, U, G).astype(np.float32) * 0.4
    fin = F if mode == "add" else F + G
    params = dict(w_pre=rng.randn(fin, H).astype(np.float32) * 0.3,
                  b_pre=rng.randn(H).astype(np.float32) * 0.1,
                  w_out=rng.randn(H, V).astype(np.float32) * 0.3,
                  b_out=rng.randn(V).astype(np.float32) * 0.1)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([9, 7], np.int32)
    yn = np.array([3, 2], np.int32)
    return f, g, params, labels, xn, yn


@pytest.mark.parametrize("average_frames", [False, True])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("mode", ["add", "concat"])
def test_public_wrapper_matches_jax(mode, reduction, average_frames):
    f, g, params, labels, xn, yn = _wrapper_inputs(mode)
    kw = dict(reduction=reduction, average_frames=average_frames, mode=mode)
    weights = np.array([0.6, 1.4], np.float32)

    ft, gt = torch.tensor(f, requires_grad=True), torch.tensor(g, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = wt.rnnt_loss_fused_joint(ft, gt, pt, *tt(labels, xn, yn), **kw)
    (out * torch.tensor(weights) if reduction == "none" else out).sum().backward()

    def jloss(f, g, p):
        o = jfj.rnnt_loss_fused_joint(f, g, p, jnp.asarray(labels), xn, yn,
                                      impl="scan", **kw)
        return (o * weights if reduction == "none" else o).sum(), o

    (_, jout), (jgf, jgg, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True
    )(jnp.asarray(f), jnp.asarray(g), {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-3)
    _close(ft.grad.numpy(), jgf, **WRAPPER_TOL, name="f")
    _close(gt.grad.numpy(), jgg, **WRAPPER_TOL, name="g")
    for k in params:
        _close(pt[k].grad.numpy(), jgp[k], **WRAPPER_TOL, name=k)


def _flax_joint(mode, normalize_inputs_seed=7):
    import flax.linen as nn

    from warp_rnnt_tpu.models.joint import Joint as FlaxJoint

    rng = np.random.RandomState(normalize_inputs_seed)
    N, T, U, V, H, F = 2, 6, 4, 37, 32, 24
    f = rng.randn(N, T, F).astype(np.float32)
    g = rng.randn(N, U, F).astype(np.float32)
    joint = FlaxJoint(vocab_size=V, hidden=H, mode=mode)
    variables = nn.unbox(joint.init(jax.random.PRNGKey(0), jnp.asarray(f),
                                    jnp.asarray(g)))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    return joint, variables, tree, f, g


def _bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("mode", ["add", "concat"])
def test_joint_matches_flax(mode, normalize):
    """Flax and torch sum the bf16 products in another order before the
    rounding to bf16, so outputs agree within 2 bf16 ulps of their scale."""
    fjoint, variables, tree, f, g = _flax_joint(mode)
    joint, _ = carry_flax_joint(tree, mode=mode, device="cpu")
    want = np.asarray(fjoint.apply(variables, jnp.asarray(f), jnp.asarray(g),
                                   normalize=normalize))
    with torch.no_grad():
        got = joint(*tt(f, g), normalize=normalize).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * _bf16_ulp(np.abs(want).max()))


def test_carried_params_drive_the_fused_loss():
    """The params dict of `carry_flax_joint` gives the fused loss the same
    joint as the module: fused == Joint(normalize=True) + rnnt_loss within
    the rtol 2e-3 of the bf16 roundings the module adds."""
    _, _, tree, f, g = _flax_joint("add")
    joint, params = carry_flax_joint(tree, device="cpu")
    assert params["w_pre"].shape == (24, 32) and params["w_out"].shape == (32, 37)
    np.testing.assert_array_equal(joint.pre.weight.detach().numpy(),
                                  params["w_pre"].numpy().T)
    rng = np.random.RandomState(8)
    labels = rng.randint(1, 37, (2, 3)).astype(np.int32)
    xn, yn = np.array([6, 4], np.int32), np.array([3, 1], np.int32)
    with torch.no_grad():
        fused = wt.rnnt_loss_fused_joint(*tt(f, g), params, *tt(labels, xn, yn))
        lp = joint(*tt(f, g)).contiguous()
        ref = rnnt_loss(lp, *tt(labels, xn, yn), gather=True)
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=2e-3)


def test_grads_zero_outside_valid_region():
    """d_a rows past xn and d_c rows past yn+1 are exactly zero."""
    a, c, w, b, labels, _, _ = _setup(N=2, T=12, U=6)
    xn = np.array([8, 6], np.int32)
    yn = np.array([3, 2], np.int32)
    at, ct = torch.tensor(a, requires_grad=True), torch.tensor(c, requires_grad=True)
    fj.fused_joint_core(at, ct, *tt(w, b, labels, xn, yn)).sum().backward()
    da, dc = at.grad.numpy(), ct.grad.numpy()
    assert (da[0, 8:] == 0).all() and (da[1, 6:] == 0).all()
    assert (dc[0, 4:] == 0).all() and (dc[1, 3:] == 0).all()
    assert np.abs(da[0, :8]).max() > 0 and np.abs(dc[1, :3]).max() > 0


def test_no_grad_route_same_costs(monkeypatch):
    """Without a gradient the beta-only sweep gives the grad-mode costs; the
    alpha+grads sweep does not run."""
    a, c, w, b, labels, xn, yn = _setup(N=3, T=9, U=4, V=25, seed=6)
    args = tt(a, c, w, b, labels, xn, yn)
    at = args[0].clone().requires_grad_()
    with_grad = fj.fused_joint_core(at, *args[1:], 0, 0.0).detach()

    def _boom(*a, **k):
        raise AssertionError("alpha+grads sweep ran")

    monkeypatch.setattr(fj, "_forward_backward", _boom)
    with torch.no_grad():
        c1 = fj.fused_joint_core(at, *args[1:])
    c2 = fj.fused_joint_core(*args)
    for c_ in (c1, c2):
        np.testing.assert_allclose(c_.numpy(), with_grad.numpy(), rtol=1e-5)
    with pytest.raises(AssertionError, match="sweep ran"):
        fj.fused_joint_core(at, *args[1:])


@pytest.mark.parametrize("case,match", [
    ("reduction", "Unknown reduction method"),
    ("mode", "unknown joint mode"),
])
def test_wrapper_value_errors(case, match):
    f, g, params, labels, xn, yn = _wrapper_inputs("add")
    kw = {"reduction": "avg"} if case == "reduction" else {"mode": "mul"}
    pt = {k: torch.tensor(v) for k, v in params.items()}
    with pytest.raises(ValueError, match=match):
        wt.rnnt_loss_fused_joint(*tt(f, g), pt, *tt(labels, xn, yn), **kw)
    with pytest.raises(ValueError, match=match):
        jfj.rnnt_loss_fused_joint(jnp.asarray(f), jnp.asarray(g), params,
                                  jnp.asarray(labels), xn, yn, **kw)


@pytest.mark.parametrize("case,match", [
    ("H", "empty joint"),
    ("device", "unsupported device"),
    ("labels_shape", "labels_ext must be"),
    ("blank", "outside"),
])
def test_kernel_wrapper_checks_raise(case, match):
    a, c, w, b, labels, xn, yn = _setup(H=0 if case == "H" else 16)
    lab = _labels_ext(torch.tensor(labels), 0)
    if case == "labels_shape":
        lab = lab[:, :-1]
    blank = w.shape[1] if case == "blank" else 0
    with pytest.raises(ValueError, match=match):
        fj._kernel_inputs(*tt(a, c, w, b), lab, torch.tensor(xn), blank)


@pytest.mark.parametrize("H,want", [(1, (16, 1)), (16, (16, 1)), (40, (48, 1)),
                                    (200, (208, 1)), (512, (512, 1)),
                                    (513, (544, 2)), (640, (640, 2)),
                                    (1000, (1024, 2)), (2048, (2048, 4)),
                                    (2500, (2560, 5))])
def test_h_plan(H, want):
    """Whole slices of at most 512 columns, each a multiple of 16, as few
    and as even as that allows; never narrower than H."""
    Hp, S = fj.h_plan(H)
    assert (Hp, S) == want
    assert Hp % S == 0 and (Hp // S) % 16 == 0 and Hp // S <= 512
    assert 0 <= Hp - H < 16 * S


def test_padded_operands_give_the_unpadded_outputs():
    """The plain versions on `pad_h`'s operands (H=40 -> 48 zero-padded
    columns of a and c, rows of W) give the unpadded forward and, through
    `unpad_h`, the unpadded backward (fp32 sums of other lengths: 1e-6);
    the padded columns and rows of d_a, d_c and d_W are exactly 0."""
    ops, (db, de) = cases.kernel_case(33, 2, 11, 5, 70, 40, 3, (11, 6), "cpu")
    a, c, w, b, lab, xn, yn = ops
    Hp, _ = fj.h_plan(40)
    pa, pc, pw = fj.pad_h(a, c, w, Hp)
    assert pa.shape[-1] == pc.shape[-1] == pw.shape[0] == Hp == 48
    assert all(x is y for x, y in zip(fj.pad_h(a, c, w, 40), (a, c, w)))
    want = fj.joint_lattice_fwd_plain(*ops, 3)
    got = fj.joint_lattice_fwd_plain(pa, pc, pw, b, lab, xn, yn, 3)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)
    args = (lab, xn, yn, want[2], db, de, 3)
    want = fj.joint_lattice_bwd_plain(a, c, w, b, *args)
    padded = fj.joint_lattice_bwd_plain(pa, pc, pw, b, *args)
    got = (*fj.unpad_h(*padded[:3], 40), padded[3])
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)
    for x in (padded[0][..., 40:], padded[1][..., 40:], padded[2][40:]):
        assert not x.any()


@pytest.mark.parametrize("H", [40, 640])
def test_wide_joint_matches_jax(H):
    """`rnnt_loss_fused_joint` (plain versions here) against JAX's at a
    joint width that is no multiple of 16 and one past a 512-column slice
    (JAX's kernels take any H): loss rtol 2e-3 and the gradients of f, g and
    the four parameters within the tolerances of `test_fused_joint.py:
    161-165`."""
    rng = np.random.RandomState(12)
    N, T, U, V, F = 2, 6, 4, 29, 12
    f = rng.randn(N, T, F).astype(np.float32) * 0.4
    g = rng.randn(N, U, F).astype(np.float32) * 0.4
    params = dict(w_pre=rng.randn(F, H).astype(np.float32) / np.sqrt(F),
                  b_pre=rng.randn(H).astype(np.float32) * 0.1,
                  w_out=rng.randn(H, V).astype(np.float32) / np.sqrt(H),
                  b_out=rng.randn(V).astype(np.float32) * 0.1)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn, yn = np.array([6, 5], np.int32), np.array([3, 2], np.int32)
    ft, gt = torch.tensor(f, requires_grad=True), torch.tensor(g, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = wt.rnnt_loss_fused_joint(ft, gt, pt, *tt(labels, xn, yn),
                                   reduction="mean")
    out.backward()

    def jloss(f, g, p):
        return jfj.rnnt_loss_fused_joint(f, g, p, jnp.asarray(labels), xn, yn,
                                         impl="scan", reduction="mean")

    jout, (jgf, jgg, jgp) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(f), jnp.asarray(g),
        {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(float(out.detach()), float(jout), rtol=2e-3)
    _close(ft.grad.numpy(), jgf, **WRAPPER_TOL, name="f")
    _close(gt.grad.numpy(), jgg, **WRAPPER_TOL, name="g")
    for k in params:
        _close(pt[k].grad.numpy(), jgp[k], **WRAPPER_TOL, name=k)


def test_joint_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown joint mode"):
        Joint(10, 8, 8, mode="mul")


# ---- the kernels' comparison with their plain versions ---------------------

def _no_softmax(orig):
    """`_dlogits` without its softmax term (an infinite logZ)."""
    def dlogits(z, labels_ext, xn, logz, db, de, blank):
        return orig(z, labels_ext, xn, torch.full_like(logz, float("inf")), db,
                    de, blank)
    return dlogits


def _logz_off(orig):
    """`_dlogits` reading a logZ 0.05 too large (softmax 5 % too small)."""
    def dlogits(z, labels_ext, xn, logz, db, de, blank):
        return orig(z, labels_ext, xn, logz + 0.05, db, de, blank)
    return dlogits


def _faulty_backward(monkeypatch, fault):
    """(ops, plain backward, backward with ``fault`` in its dz) at a V where
    most columns are reached by the softmax term alone."""
    ops, (db, de) = cases.kernel_case(30, 2, 30, 6, 1000, 32, 0, (30, 17), "cpu")
    logz = fj.joint_lattice_fwd_plain(*ops, 0)[2]
    args = (*ops, logz, db, de, 0)
    want = fj.joint_lattice_bwd_plain(*args)
    monkeypatch.setattr(fj, "_dlogits", fault(fj._dlogits))
    return ops, want, fj.joint_lattice_bwd_plain(*args)


@pytest.mark.parametrize("output", [0, 1, 2, 3])
@pytest.mark.parametrize("fault", [_no_softmax, _logz_off])
def test_backward_check_rejects_a_wrong_softmax_term(monkeypatch, fault, output):
    """The kernels' backward check (d_W, d_b per column group) rejects a
    backward that drops or mis-scales the softmax term of dz."""
    ops, want, bad = _faulty_backward(monkeypatch, fault)
    cases.check_backward(want, want, ops[4], 0)
    got = tuple(bad[i] if i == output else want[i] for i in range(4))
    with pytest.raises(AssertionError, match="max abs err"):
        cases.check_backward(got, want, ops[4], 0)


@pytest.mark.parametrize("output", [2, 3])
def test_whole_tensor_check_misses_a_logz_fault(monkeypatch, output):
    """Why d_W and d_b are held per column group: against one largest entry
    over all columns (the blank column's), a logZ fault passes."""
    ops, want, bad = _faulty_backward(monkeypatch, _logz_off)
    cases.check_close("whole", bad[output], want[output], cases.BWD_RTOL)
    groups = cases.column_groups(ops[4], 0, want[3].shape[0])
    with pytest.raises(AssertionError, match=r"columns\): max abs err"):
        cases.check_close("grouped", bad[output], want[output], cases.BWD_RTOL,
                          groups)


def test_column_groups():
    lab = torch.tensor([[5, 0, 2], [7, 2, 0]], dtype=torch.int32)
    ids = cases.column_groups(lab, 0, 9).tolist()
    assert ids == [0, 2, 1, 2, 2, 1, 2, 1, 2]


def test_forward_check_ignores_frames_past_lengths():
    ops, _ = cases.kernel_case(31, 2, 6, 3, 40, 16, 0, (6, 2), "cpu")
    want = fj.joint_lattice_fwd_plain(*ops, 0)
    got = tuple(x.clone() for x in want)
    got[2][1, 2:] = 7.0
    assert cases.check_forward(got, want, ops[5]) == 0.0
    got[2][1, 1, 0] += 2e-4
    with pytest.raises(AssertionError, match="logZ"):
        cases.check_forward(got, want, ops[5])


def test_project_matches_the_wrapper():
    """`_project`, which chip_smoke.py uses for the kernels' full-width
    operands, is the projection the public wrapper feeds the core."""
    f, g, params, labels, xn, yn = _wrapper_inputs("concat")
    pt = {k: torch.tensor(v) for k, v in params.items()}
    a, c = fj._project(*tt(f, g), pt, "concat")
    costs = fj.fused_joint_core(a, c, pt["w_out"], pt["b_out"],
                                *tt(labels, xn, yn))
    want = wt.rnnt_loss_fused_joint(*tt(f, g), pt, *tt(labels, xn, yn),
                                    mode="concat")
    torch.testing.assert_close(costs, want, rtol=0, atol=0)


def test_joint_makes_its_parameters_on_the_card_by_default():
    assert inspect.signature(Joint).parameters["device"].default == "cuda"
    assert inspect.signature(carry_flax_joint).parameters["device"].default == "cuda"
    joint = Joint(11, 8, 16, device="cpu")
    assert {p.device.type for p in joint.parameters()} == {"cpu"}


# ---- on the card: kernels against their plain versions --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(cases.KERNEL_CASES))
def test_kernels_match_plain_on_card(cuda_device, case):
    """Both on the card, so both take the card's tanhf and round h alike;
    the comparison of `fused_joint_cases` (chip_smoke.py makes the same)."""
    ops, cot = cases.kernel_case(*cases.KERNEL_CASES[case], device=cuda_device)
    cases.compare(fj, ops, cot, cases.KERNEL_CASES[case][6])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(cases.LARGE_V_CASES))
def test_kernels_match_plain_on_card_large_v(cuda_device, case):
    """At the vocabularies where JAX takes its V-blocked kernels."""
    ops, cot = cases.kernel_case(*cases.LARGE_V_CASES[case], device=cuda_device)
    cases.compare(fj, ops, cot, cases.LARGE_V_CASES[case][6])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(cases.WIDE_CASES))
def test_kernels_match_plain_on_card_wide(cuda_device, case):
    """H not a multiple of 16 (padded), H > 512 (the sliced route and its
    h kernel, launched then and only then), and N > 65535 (grid x)."""
    ops, cot = cases.kernel_case(*cases.WIDE_CASES[case], device=cuda_device)
    before = fj.LAUNCHES["fused_joint_hidden"]
    cases.compare(fj, ops, cot, cases.WIDE_CASES[case][6])
    sliced = fj.h_plan(cases.WIDE_CASES[case][5])[1] > 1
    assert (fj.LAUNCHES["fused_joint_hidden"] > before) == sliced
