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
  * the kernels' padding of H: the plain versions on `pad_h`'s operands
    (`bwd_plan`'s width) giving the unpadded outputs (H=40); the wrapper
    against JAX at H=40 and H=640 (three 256-column slices);
  * the comparison that holds the kernels to their plain versions
    (`benchmarks/fused_joint_cases.py`) rejects a backward with a dropped or
    mis-scaled softmax term;
  * the kernels' planning: `bwd_plan`'s widths, the W and h images read
    back by the kernels' address rules, the tiles' cover of the lattice,
    and every (tile, chunk, slice) owned by one block (`_v_parts`,
    `_row_groups`);
  * the forward's V parts: the plain logits cut into parts, their per-row
    partials merged by `merge_v_parts`, equal the plain forward.
Kernel-against-plain-version tests need the card and are marked `cuda`
(with two forward and two backward calls bit-equal).
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


@pytest.mark.parametrize("H,want", [(1, (64, 1)), (64, (64, 1)), (200, (256, 1)),
                                    (256, (256, 1)), (257, (384, 2)),
                                    (272, (384, 2)), (512, (512, 2)),
                                    (640, (768, 3)), (1000, (1024, 4)),
                                    (2048, (2048, 8))])
def test_bwd_plan(H, want):
    """The kernels' slices: whole wgmma N tiles (64 columns), at most 256
    (a warpgroup's d_h or d_W in registers), as few and as even as that
    allows; never narrower than H."""
    Hp, S = fj.bwd_plan(H)
    assert (Hp, S) == want
    assert Hp % S == 0 and (Hp // S) % 64 == 0 and Hp // S <= 256
    assert 0 <= Hp - H < 64 * S


# ---- the backward kernels' address and ownership rules, as in
# `csrc/fused_joint.cu` --------------------------------------------------

def _w_image_offset(k, v, HS):
    """Element offset of W[k, v] (k within the slice) in its W image block:
    8 x 8 core matrices of 16-byte rows, each row 8 columns v of one k;
    k-neighbouring core matrices 128 bytes apart, v-neighbouring HS * 16
    (the descriptors `desc_w`, `desc_wt`)."""
    return (k // 8) * 64 + (v // 8) * HS * 8 + (k % 8) * 8 + v % 8


def _dadc_blocks(tiles, S, chunks, parts):
    """{(tile, slice, 64-column chunk): block (x, o, p)} of `dadc_kernel`:
    block x owns tiles 2x and 2x + 1 (one a consumer warpgroup), o its d_h
    slice, p the chunks [p * cpp, (p + 1) * cpp), cpp = ceil(chunks /
    parts)."""
    cpp = -(-chunks // parts)
    return {(t, o, ch): (t // 2, o, ch // cpp) for o in range(S)
            for t in range(tiles) for ch in range(chunks)}


def _dwdb_blocks(tiles, V, groups, S):
    """{(tile, 64-column chunk, slice): block (q, grp, o)} of `dwdb_kernel`:
    block q owns chunks 2q and 2q + 1 (one a consumer warpgroup), grp the
    tiles [grp * per, (grp + 1) * per), per = ceil(tiles / groups), o its
    d_W slice."""
    per = -(-tiles // groups)
    out = {}
    for q in range(-(-V // 128)):
        for grp in range(groups):
            for o in range(S):
                for t in range(grp * per, min(tiles, (grp + 1) * per)):
                    for ch in (2 * q, 2 * q + 1):
                        if ch * 64 < V:
                            out[(t, ch, o)] = (q, grp, o)
    return out


@pytest.mark.parametrize("V,HS,S", [(200, 64, 1), (320, 128, 2), (64, 256, 1)])
def test_w_image_reads_back_w_and_bias(V, HS, S):
    """`_w_image` is a permutation of W (zero columns past V): read back by
    the kernels' address rule (`_w_image_offset`) every block gives its
    slice and chunk of W, then the chunk's biases (-inf past V); the chunk
    count is even, so 128-column chunks are whole."""
    rng = np.random.RandomState(V + HS)
    w = torch.tensor(rng.randn(HS * S, V), dtype=torch.float32).to(torch.bfloat16)
    b = torch.tensor(rng.randn(V), dtype=torch.float32)
    img = fj._w_image(w, b, V, HS * S, S)
    nc = fj._w_chunks(V)
    assert nc % 2 == 0 and (nc - 2) * 64 < V <= nc * 64
    assert img.shape == (S, nc, HS * 64 + 128) and img.dtype == torch.bfloat16
    k, v = torch.meshgrid(torch.arange(HS), torch.arange(64), indexing="ij")
    off = _w_image_offset(k, v, HS)
    assert sorted(off.flatten().tolist()) == list(range(HS * 64))
    wpad = torch.nn.functional.pad(w, (0, nc * 64 - V))
    for s in range(S):
        for ch in range(nc):
            block = img[s, ch]
            want = wpad[s * HS:(s + 1) * HS, ch * 64:(ch + 1) * 64]
            assert torch.equal(block[off], want)
            bias = block[HS * 64:].contiguous().view(torch.float32)
            cols = torch.arange(ch * 64, ch * 64 + 64)
            ref = torch.where(cols < V, b[cols.clamp(max=V - 1)],
                              float("-inf"))
            assert torch.equal(bias, ref)


@pytest.mark.parametrize("N,T,U", [(2, 7, 5), (1, 3, 70), (3, 2, 129),
                                   (2, 9, 21)])
def test_tile_cells_cover_the_lattice_once(N, T, U):
    """Every lattice cell is one row of one tile; a tile is 64 rows of one
    sample (whole frames when U <= 64, one frame's U chunk otherwise)."""
    cells = fj.tile_cells(N, T, U)
    assert cells.shape == (fj.n_tiles(N, T, U), 64)
    got = cells[cells >= 0]
    assert sorted(got.tolist()) == list(range(N * T * U))
    n = torch.where(cells >= 0, cells // (T * U), -1)
    for row in n:
        assert len(set(row[row >= 0].tolist())) == 1


@pytest.mark.parametrize("N,T,U,S", [(2, 7, 5, 1), (1, 3, 70, 2), (2, 4, 9, 3)])
def test_hidden_image_reads_back_h(N, T, U, S):
    """The backward's h image (`h_image`, which `hidden_image_plain` applies
    to `hidden_plain`'s rows) read back by the kernels' address rule,
    (row/8)*64 + (k/8)*512 + (row%8)*8 + k%8 inside block (tile, slice),
    gives bf16 h of each tile row, zero where the row is not live or past
    the lattice."""
    HS = 64
    rng = np.random.RandomState(N * T * U)
    a = torch.tensor(rng.randn(N, T, HS * S), dtype=torch.float32)
    c = torch.tensor(rng.randn(N, U, HS * S), dtype=torch.float32)
    xn = torch.tensor(rng.randint(1, T + 1, N), dtype=torch.int32)
    rows = fj.hidden_plain(a, c, xn)
    img = fj.h_image(rows, N, T, U, S)
    tiles = fj.n_tiles(N, T, U)
    assert img.shape == (tiles, S, 64 * HS)
    assert fj.hidden_image_plain(a, c, xn, S).shape == img.shape
    cells = fj.tile_cells(N, T, U)
    r, k = torch.meshgrid(torch.arange(64), torch.arange(HS), indexing="ij")
    off = (r // 8) * 64 + (k // 8) * 512 + (r % 8) * 8 + k % 8
    for tile in range(tiles):
        for s in range(S):
            got = img[tile, s][off]
            for i in range(64):
                cell = int(cells[tile, i])
                want = (rows[cell, s * HS:(s + 1) * HS] if cell >= 0
                        else torch.zeros(HS, dtype=torch.bfloat16))
                assert torch.equal(got[i], want)


@pytest.mark.parametrize("tiles,S,V", [(1, 1, 77), (7, 1, 5000), (8, 3, 200),
                                       (100, 1, 64000), (50, 1, 50257)])
def test_dadc_schedule_owns_each_tile_slice_chunk_once(tiles, S, V):
    """`_v_parts`' count at 132 SMs, and `_dadc_blocks`: each (tile, slice,
    64-column chunk) has one d_a / d_c block, at most two tiles a block, no
    V part empty; the d_a and d_c partials (one per block) are summed in a
    fixed order."""
    chunks = -(-V // 64)
    parts = fj._v_parts(132, tiles, S, V)
    assert 1 <= parts <= chunks
    cpp = -(-chunks // parts)
    assert (parts - 1) * cpp < chunks
    own = _dadc_blocks(tiles, S, chunks, parts)
    assert set(own) == {(t, o, ch) for t in range(tiles) for o in range(S)
                        for ch in range(chunks)}
    blocks = {}
    for (t, o, ch), blk in own.items():
        blocks.setdefault(blk, set()).add(t)
    assert len(blocks) == -(-tiles // 2) * S * parts
    assert all(len(ts) <= 2 for ts in blocks.values())


def test_v_parts_fill_the_card():
    """V=64000 at N=2 (100 tiles, 50 blocks) takes 5 V parts, 250 blocks;
    V=50257 at N=1 (25 blocks) 5; the fused slice (400 blocks, three
    waves) and wide grids 1."""
    assert fj._v_parts(132, 100, 1, 64000) == 5
    assert fj._v_parts(132, 50, 1, 50257) == 5
    assert fj._v_parts(132, 800, 1, 5000) == 1
    assert fj._v_parts(132, 800, 4, 5000) == 1


def _fwd_blocks(tiles, V, parts):
    """{(tile, 64-column chunk): block (x, p)} of `fwd_kernel`: block x owns
    tiles 2x and 2x + 1 (one a consumer warpgroup), p the chunks [p * cpp,
    (p + 1) * cpp) of the ceil(V / 64) that hold a column of V, cpp =
    ceil(chunks / parts); every slice sums into the same logits."""
    chunks = -(-V // 64)
    cpp = -(-chunks // parts)
    return {(t, ch): (t // 2, ch // cpp) for t in range(tiles)
            for ch in range(chunks)}


@pytest.mark.parametrize("tiles,V", [(800, 5000), (100, 64000), (50, 50257),
                                     (2, 65), (2, 1025), (65537, 64)])
def test_fwd_schedule_owns_each_tile_chunk_once(tiles, V):
    """`_v_parts`' count for the forward (no slice dimension) at 132 SMs,
    and `_fwd_blocks`: each (tile,
    chunk) has one forward block, at most two tiles a block, no V part
    empty; the parts cover the chunks that hold a column of V once, and
    the W image's other blocks (`_w_chunks`) hold padding only.  At the
    large-V cells (V=64000, N=2: 100 tiles; V=50257, N=1: 50) the grid is
    about a wave of 132 SMs or more."""
    parts = fj._v_parts(132, tiles, 1, V)
    chunks = -(-V // 64)
    cpp = -(-chunks // parts)
    assert 1 <= parts <= chunks and (parts - 1) * cpp < chunks
    own = _fwd_blocks(tiles, V, parts)
    assert set(own) == {(t, ch) for t in range(tiles) for ch in range(chunks)}
    assert set(p for _, p in own.values()) == set(range(parts))
    blocks = {}
    for (t, _), blk in own.items():
        blocks.setdefault(blk, set()).add(t)
    assert len(blocks) == -(-tiles // 2) * parts
    assert all(len(ts) <= 2 for ts in blocks.values())
    assert all(ch * 64 >= V for ch in range(chunks, fj._w_chunks(V)))
    if V >= 50257:
        assert len(blocks) >= 0.9 * 132


def _fwd_partials(ops, blank, parts, chunks):
    """Plain per-part (max, sum of exp(z - max), blank logit, label logit)
    of the logits cut into ``parts`` parts of ceil(chunks / parts) 64-column
    chunks (columns past V padding, -inf): what the forward kernel writes
    when it splits V.  (4, parts, N, T, U)."""
    a, c, w, b, lab, xn, yn = ops
    z = fj._logits(a, c, w, b)[3]
    V = z.shape[-1]
    z = torch.nn.functional.pad(z, (0, chunks * 64 - V), value=float("-inf"))
    cpp = -(-chunks // parts)
    labs = lab.long()[:, None, :].expand(z.shape[:3])
    out = []
    for p in range(parts):
        lo, hi = p * cpp * 64, min(chunks, (p + 1) * cpp) * 64
        zz = z[..., lo:hi]
        m = zz.amax(-1)
        ref = torch.where(torch.isfinite(m), m, 0.0)
        s = torch.exp(zz - ref[..., None]).sum(-1)
        bl = zz[..., blank - lo] if lo <= blank < hi else torch.zeros_like(m)
        inside = (labs >= lo) & (labs < hi)
        el = torch.where(inside, torch.gather(
            zz, 3, (labs - lo).clamp(0, hi - lo - 1)[..., None])[..., 0], 0.0)
        out.append(torch.stack((m, s, bl, el)))
    return torch.stack(out, 1)


# name: (kernel case (seed, N, T, U, V, H, blank, xn), parts, chunks or None
# for ceil(V / 64))
_MERGE_CASES = {
    "V<64": ((50, 2, 6, 4, 40, 16, 0, (6, 3)), 1, None),
    "V not a multiple of 64": ((51, 2, 5, 3, 130, 16, 0, (5, 2)), 2, None),
    "one part": ((52, 1, 7, 5, 200, 16, 3, (7,)), 1, None),
    "parts = chunks": ((53, 2, 4, 3, 300, 16, 0, (4, 1)), 5, None),
    "all-padding part": ((54, 2, 4, 3, 64, 16, 0, (4, 3)), 2, 2),
    "blank in the last part": ((55, 1, 5, 4, 320, 16, 319, (5,)), 3, None),
    "label in the last part": ((56, 2, 5, 4, 257, 16, 0, (5, 4)), 3, None),
}


@pytest.mark.parametrize("name", list(_MERGE_CASES))
def test_merge_v_parts_gives_the_plain_forward(name):
    """The partials of the plain logits, cut into V parts and merged by
    `merge_v_parts`, equal `joint_lattice_fwd_plain` (fp32 sums in another
    order: 1e-5), exactly 0 at frames t >= xn."""
    case, parts, chunks = _MERGE_CASES[name]
    ops, _ = cases.kernel_case(*case, device="cpu")
    blank, V = case[6], case[4]
    if name == "label in the last part":
        ops[4][:, 0] = V - 1
    part = _fwd_partials(ops, blank, parts, chunks or -(-V // 64))
    live = fj._live(ops[5], case[2])
    got = fj.merge_v_parts(part, live)
    want = fj.joint_lattice_fwd_plain(*ops, blank)
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
        assert (g[~live.expand_as(g)] == 0).all()


@pytest.mark.parametrize("tiles,V,S", [(800, 5000, 1), (13, 200, 2),
                                       (1, 64, 1), (65537, 64, 1)])
def test_dwdb_schedule_owns_each_tile_chunk_slice_once(tiles, V, S):
    """`_row_groups`' count at 132 SMs, and `_dwdb_blocks`: every (tile,
    64-column chunk, slice) is owned by exactly one block, each group's
    tiles are consecutive, and at most ~3 waves of blocks fill the card."""
    groups = fj._row_groups(132, V, tiles, S)
    chunks = -(-V // 128)
    assert 1 <= groups <= tiles and chunks * S * groups <= max(3 * 132, chunks * S)
    own = _dwdb_blocks(tiles, V, groups, S)
    want = {(t, ch, o) for t in range(tiles) for ch in range(-(-V // 64))
            for o in range(S)}
    assert set(own) == want
    per = -(-tiles // groups)
    for (t, ch, o), (q, grp, o2) in own.items():
        assert q == ch // 2 and o2 == o and grp == t // per


def test_row_groups_fill_the_card():
    """V=5000 (40 chunks of 128): 3 groups, 120 blocks on 132 SMs; fewer
    chunks take more groups."""
    assert fj._row_groups(132, 5000, 800) == 3
    assert fj._row_groups(132, 64, 800) > 100
    assert fj._row_groups(132, 64000, 80) == 1


def test_padded_operands_give_the_unpadded_outputs():
    """The plain versions on `pad_h`'s operands (H=40 -> `bwd_plan`'s 64
    zero-padded columns of a and c, rows of W) give the unpadded forward
    and, through `unpad_h`, the unpadded backward (fp32 sums of other
    lengths: 1e-6); the padded columns and rows of d_a, d_c and d_W are
    exactly 0."""
    ops, (db, de) = cases.kernel_case(33, 2, 11, 5, 70, 40, 3, (11, 6), "cpu")
    a, c, w, b, lab, xn, yn = ops
    Hp, _ = fj.bwd_plan(40)
    pa, pc, pw = fj.pad_h(a, c, w, Hp)
    assert pa.shape[-1] == pc.shape[-1] == pw.shape[0] == Hp == 64
    assert fj.pad_h(a, c, None, Hp)[2] is None
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
    joint width that is no multiple of 16 and one of three 256-column
    slices (JAX's kernels take any H): loss rtol 2e-3 and the gradients of f, g and
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
    """H not a multiple of 64 (padded), H past a slice (the sliced route
    and its h kernel, launched if and only if `bwd_plan` gives more than
    one slice), and N > 65535 (grid x)."""
    ops, cot = cases.kernel_case(*cases.WIDE_CASES[case], device=cuda_device)
    before = fj.LAUNCHES["fused_joint_hidden"]
    cases.compare(fj, ops, cot, cases.WIDE_CASES[case][6])
    H = cases.WIDE_CASES[case][5]
    launched = fj.LAUNCHES["fused_joint_hidden"] > before
    assert launched == (fj.bwd_plan(H)[1] > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "H=272 xn=1"])
def test_backward_is_deterministic_on_card(cuda_device, case):
    """Two backward calls give bit-equal d_a, d_c, d_W and d_b: the
    partials are summed in a fixed order, with no atomics."""
    ops, (db, de) = cases.kernel_case(*cases.KERNEL_CASES[case],
                                      device=cuda_device)
    blank = cases.KERNEL_CASES[case][6]
    logz = fj.joint_lattice_fwd(*ops, blank)[2]
    first = fj.joint_lattice_bwd(*ops, logz, db, de, blank)
    second = fj.joint_lattice_bwd(*ops, logz, db, de, blank)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "V=64000"])
def test_forward_is_deterministic_on_card(cuda_device, case):
    """Two forward calls give bit-equal blank logits, label logits and
    logZ, with one V part ("ragged") and with 125, merged in a fixed
    order (V=64000 at N=1, T=20, U=6: two tiles, one block a part)."""
    spec = {**cases.KERNEL_CASES, **cases.LARGE_V_CASES}[case]
    ops, _ = cases.kernel_case(*spec, device=cuda_device)
    first = fj.joint_lattice_fwd(*ops, spec[6])
    second = fj.joint_lattice_fwd(*ops, spec[6])
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [200, 333, 512, 640, 1024])
@pytest.mark.parametrize("N,T,U", [(3, 17, 21), (2, 5, 70)])
def test_hidden_image_kernel_matches_plain_on_card(cuda_device, N, T, U, H):
    """The h image kernel at `bwd_plan(H)`'s slices (H=200: one; 333 odd,
    padded to 384) against `hidden_image_plain` within one bf16 ulp of
    |h| <= 1 (2^-8; the card's tanhf against torch's can flip a rounding),
    ragged frames, U past 64 (a tile's 64 rows one frame's chunk, 65 staged
    rows); two calls bit-equal."""
    Hp, S = fj.bwd_plan(H)
    rng = np.random.RandomState(H + U)
    a = torch.tensor(rng.randn(N, T, H), dtype=torch.float32)
    c = torch.tensor(rng.randn(N, U, H), dtype=torch.float32)
    xn = torch.tensor(rng.randint(1, T + 1, N), dtype=torch.int32)
    pa, pc, _ = fj.pad_h(a, c, None, Hp)
    pa, pc = pa.to(cuda_device).contiguous(), pc.to(cuda_device).contiguous()
    xn = xn.to(cuda_device)
    dims = (N, T, U, Hp, 0, S)
    first = fj._hidden_image(pa, pc, xn, dims)
    second = fj._hidden_image(pa, pc, xn, dims)
    want = fj.hidden_image_plain(pa, pc, xn, S)
    torch.cuda.synchronize()
    assert first.shape == want.shape and first.dtype == want.dtype
    assert float((first.float() - want.float()).abs().max()) <= 2.0 ** -8
    assert torch.equal(first, second)
