"""Parity of the PyTorch port's benchmark tier with the JAX package, on the
CPU: `benchmarks/bench_loss.py`, `run_table.py` and `bench_joint.py`.

  * bench_loss: `CONFIGS` equal JAX's; `make_batch` on the CPU (shapes,
    dtypes, label and length ranges, log-probs that sum to 1, the flat
    layout a reshape of the 4-D one); the surrogate rule against JAX's
    byte test at every row of the table; the timed loss+grad and no-grad
    calls against ``jax.value_and_grad(rnnt_loss(..., reduction="mean",
    gather=True, impl="scan"))`` and JAX's "none" costs (rtol = atol =
    1e-5, as `tests/test_torch_loss.py`); no timer without CUDA.
  * run_table: `REFERENCE_GATHER_MS` equals JAX's; without CUDA a row
    carries the child's error and no number.
  * bench_joint: lengths equal JAX's `make_inputs`; the packing equals
    JAX's numpy construction; each mode's loss and joint-parameter
    gradients against JAX's same expression (`bench_joint.py:54-118`) on
    a Flax tree carried across, full and random lengths (costs rtol 2e-3;
    gradients rtol 5e-2 with an absolute floor of 2e-2 of the largest,
    the tolerances of `tests/test_torch_joint_loss.py`: both joints round
    to bf16, and JAX's and torch's fp32 tanh differ in the last bit now
    and then, which flips a rounding).  On the CPU "auto" is "padded" on
    both sides.
  * bench_decode_traffic (no JAX counterpart): its requests, drawn from a
    seed on the CPU (batch sizes, lengths, valid lengths in range, one
    sample a request at full length, the same draw from the same seed);
    no run without CUDA.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import tt
import warp_rnnt_tpu
from warp_rnnt_tpu.benchmarks import bench_joint as jbj
from warp_rnnt_tpu.benchmarks import bench_loss as jbl
from warp_rnnt_tpu.benchmarks import run_table as jrt
from warp_rnnt_tpu_torch.benchmarks import bench_decode_traffic as bdt
from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks import run_table as rt


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


# ---- bench_loss -------------------------------------------------------------


def test_configs_equal_jax():
    assert bl.CONFIGS == jbl.CONFIGS
    assert bl.BATCHES == rt.BATCHES == (1, 16, 32, 64, 128)


@pytest.mark.parametrize("flat", [False, True])
def test_make_batch_on_cpu(flat):
    N, T, U, V = 3, 5, 4, 9
    xs, ys, xn, yn = bl.make_batch(0, N, T, U, V, flat=flat, device="cpu")
    assert xs.shape == ((N, T, (U + 1) * V) if flat else (N, T, U + 1, V))
    assert xs.dtype == torch.float32
    assert all(t.dtype == torch.int32 for t in (ys, xn, yn))
    assert ys.shape == (N, U) and xn.shape == yn.shape == (N,)
    assert int(ys.min()) >= 1 and int(ys.max()) < V
    assert (xn == T).all()
    assert int(yn.min()) >= U // 2 + 1 and int(yn.max()) <= U
    probs = xs.reshape(N, T, U + 1, V).exp().sum(-1)
    np.testing.assert_allclose(probs.numpy(), 1.0, rtol=1e-5)


def test_flat_layout_is_a_reshape():
    four = bl.make_batch(3, 2, 4, 3, 6, device="cpu")
    flat = bl.make_batch(3, 2, 4, 3, 6, flat=True, device="cpu")
    assert torch.equal(flat[0], four[0].reshape(2, 4, 4 * 6))
    for a, b in zip(four[1:], flat[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_surrogate_rule_matches_jax(dtype):
    """`uses_surrogate` against JAX `make_batch`'s byte test
    (`bench_loss.py:62-63`), at every row of the table, without
    allocating."""
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    picks = {}
    for T, U, V, _ in jbl.CONFIGS:
        for N in bl.BATCHES:
            jax_surrogate = not (
                jnp.dtype(jdtype).itemsize * N * T * (U + 1) * V <= 6 << 30)
            assert bl.uses_surrogate(N, T, U, V, dtype) == jax_surrogate
            picks[T, U, V, N] = jax_surrogate
    if dtype == torch.float32:  # 8.06 GB and 11.56 GB of log-probs
        assert [k for k, v in picks.items() if v] == [(150, 20, 5000, 128),
                                                     (1500, 300, 50, 128)]


def _small_batch(seed=0, N=2, T=6, U=3, V=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, T, U + 1, V).astype(np.float32)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    ys = rng.randint(1, V, (N, U)).astype(np.int32)
    xn = np.array([T, T - 2], np.int32)
    yn = np.array([U, U - 1], np.int32)
    return lp, ys, xn, yn


@pytest.mark.parametrize("flat", [False, True])
def test_loss_grad_step_matches_jax(flat):
    lp, ys, xn, yn = _small_batch()
    N, T, U1, V = lp.shape
    x = torch.tensor(lp.reshape(N, T, U1 * V) if flat else lp)
    loss, grad = bl.loss_grad_step(*tt(ys, xn, yn))(x)
    jloss, jgrad = jax.value_and_grad(
        lambda z: warp_rnnt_tpu.rnnt_loss(z, ys, xn, yn, reduction="mean",
                                          gather=True, impl="scan"))(
        jnp.asarray(lp))
    assert grad.shape == x.shape
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.reshape(lp.shape).numpy(),
                               np.asarray(jgrad), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flat", [False, True])
def test_no_grad_costs_match_jax(flat):
    lp, ys, xn, yn = _small_batch(seed=1)
    N, T, U1, V = lp.shape
    x = torch.tensor(lp.reshape(N, T, U1 * V) if flat else lp)
    costs = bl.costs_fn(*tt(ys, xn, yn))(x)
    jcosts = warp_rnnt_tpu.rnnt_loss(jnp.asarray(lp), ys, xn, yn,
                                     reduction="none", gather=True, impl="scan")
    assert costs.shape == (N,) and not costs.requires_grad
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("call", ["loss_grad", "no_grad", "headline",
                                  "profile", "main"])
def test_bench_loss_needs_cuda(call):
    _no_cuda()
    fn = {"loss_grad": lambda: bl.run_loss_bench(1, 4, 2, 5, 2),
          "no_grad": lambda: bl.run_loss_bench(1, 4, 2, 5, 2, grad=False),
          "headline": bl.headline,
          "profile": lambda: bl.profile_row(1, 4, 2, 5),
          "main": lambda: bl.main(["--headline"])}[call]
    with pytest.raises(SystemExit, match="CUDA device"):
        fn()


# ---- run_table --------------------------------------------------------------


def test_reference_table_equals_jax():
    assert rt.REFERENCE_GATHER_MS == jrt.REFERENCE_GATHER_MS
    assert len(rt.table_rows()) == 15
    assert [rt.iters_for(T, U) for T, U, _ in rt.REFERENCE_GATHER_MS] == [
        30, 30, 10]


def test_row_bounds():
    """The dense fp32 gradient and two log-probs a cell, over the rate."""
    lg, fwd = rt.row_bounds_ms(32, 150, 20, 5000, (1e12, 0, 0))
    cells = 32 * 150 * 21
    assert lg == pytest.approx((cells * 5000 * 4 + cells * 8) / 1e9)
    assert fwd == pytest.approx(cells * 8 / 1e9)


def test_run_table_records_an_error_without_cuda(tmp_path):
    """No fallback: the row keeps the child's error and no number."""
    _no_cuda()
    out = tmp_path / "table.json"
    doc = rt.main(str(out), rows=[(150, 40, 28, 1)])
    assert json.loads(out.read_text()) == doc
    (row,) = doc["rows"]
    assert (row["T"], row["U"], row["V"], row["N"]) == (150, 40, 28, 1)
    assert row["ref_gather_ms"] == 0.54
    assert "CUDA device" in row["error"]
    assert "loss_grad_ms" not in row and "fwd_ms" not in row
    assert doc["device"] is None and doc["torch"] == torch.__version__


# ---- bench_joint ------------------------------------------------------------


@pytest.mark.parametrize("rand_length", [False, True])
def test_make_inputs_lengths_equal_jax(rand_length):
    N, T, U, H = 16, 150, 20, 8
    f, g, ys, xn, yn = bj.make_inputs(0, N, T, U, H, rand_length, device="cpu")
    _, _, jys, jxn, jyn = jbj.make_inputs(jax.random.PRNGKey(0), N, T, U, H,
                                          rand_length)
    assert f.shape == (N, T, H) and g.shape == (N, U + 1, H)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(jxn))
    np.testing.assert_array_equal(yn.numpy(), np.asarray(jyn))
    assert (ys == 1).all() and (np.asarray(jys) == 1).all()
    assert ys.dtype == xn.dtype == yn.dtype == torch.int32


def _jax_compact_indices(xn, yn):
    """JAX's numpy construction of n_idx, t_idx, u_idx
    (`bench_joint.py:72-85`), written out."""
    xn_h, yn_h = np.asarray(xn), np.asarray(yn)
    n_idx = np.concatenate([np.full(t * (u + 1), i, np.int32)
                            for i, (t, u) in enumerate(zip(xn_h, yn_h))])
    t_idx = np.concatenate([np.repeat(np.arange(t, dtype=np.int32), u + 1)
                            for t, u in zip(xn_h, yn_h)])
    u_idx = np.concatenate([np.tile(np.arange(u + 1, dtype=np.int32), t)
                            for t, u in zip(xn_h, yn_h)])
    return n_idx, t_idx, u_idx


def test_compact_packing_equals_jax():
    """JAX's numpy construction (`bench_joint.py:72-85`), written out."""
    N, T, U = 16, 150, 20
    _, _, ys, xn, yn = bj.make_inputs(0, N, T, U, 4, True, device="cpu")
    yn_h = yn.numpy()
    want_n, want_t, want_u = _jax_compact_indices(xn.numpy(), yn_h)
    jys = np.asarray(ys.numpy())
    want_ys = np.concatenate([jys[i, :yn_h[i]] for i in range(N)])
    n_idx, t_idx, u_idx, ys_packed, T_, U_ = bj.pack(ys, xn, yn, T, U)
    for got, want in ((n_idx, want_n), (t_idx, want_t), (u_idx, want_u),
                      (ys_packed, want_ys)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert ys_packed.dtype == torch.int32 and (T_, U_) == (T, U)
    assert len(want_n) == int((xn.long() * (yn.long() + 1)).sum())


def _jax_loss_fn(mode, joint, ys, xn, yn, T, U):
    """JAX's `bench_joint.py:54-118`, loss_fn(p, f, g) of each mode."""
    import flax.linen as nn

    from warp_rnnt_tpu import rnnt_loss, rnnt_loss_from_logits, rnnt_loss_joint
    from warp_rnnt_tpu.ops.fused_joint import rnnt_loss_fused_joint

    if mode == "log_softmax+gather":
        def loss_fn(p, f, g):
            return rnnt_loss(joint.apply(p, f, g), ys, xn, yn,
                             reduction="mean", gather=True)
    elif mode == "from_logits":
        def loss_fn(p, f, g):
            logits = joint.apply(p, f, g, normalize=False)
            return rnnt_loss_from_logits(logits, ys, xn, yn, reduction="mean")
    elif mode == "compact":
        n_idx, t_idx, u_idx = map(jnp.asarray, _jax_compact_indices(xn, yn))
        yn_h = np.asarray(yn)
        ys_packed = jnp.concatenate([ys[i, : yn_h[i]]
                                     for i in range(len(yn_h))])

        def loss_fn(p, f, g):
            lp = joint.apply(p, f[n_idx, t_idx], g[n_idx, u_idx])
            return rnnt_loss(lp, ys_packed, xn, yn, reduction="mean",
                             compact=True, max_frames=T, max_labels=U)
    else:
        def loss_fn(p, f, g):
            pp = nn.unbox(p)["params"]
            fp = dict(w_pre=pp["pre"]["kernel"], b_pre=pp["pre"]["bias"],
                      w_out=pp["out"]["kernel"], b_out=pp["out"]["bias"])
            if mode == "auto":
                return rnnt_loss_joint(f, g, fp, ys, xn, yn, reduction="mean",
                                       layout="auto")
            return rnnt_loss_fused_joint(f, g, fp, ys, xn, yn, reduction="mean")
    return loss_fn


@pytest.mark.parametrize("rand_length", [False, True])
@pytest.mark.parametrize("mode", bj.MODES)
def test_joint_mode_matches_jax(mode, rand_length):
    from warp_rnnt_tpu.models.joint import Joint as JaxJoint
    from warp_rnnt_tpu_torch.models.joint import carry_flax_joint

    N, T, U, V, H = 2, 6, 3, 12, 16
    f, g, ys, xn, yn = bj.make_inputs(0, N, T, U, H, rand_length, device="cpu")
    tree = bj.joint_tree(1, H, V)
    joint, _ = carry_flax_joint(tree, device="cpu")
    packed = bj.pack(ys, xn, yn, T, U) if mode == "compact" else None
    loss, grads = bj.value_and_grad(mode, joint, f, g, ys, xn, yn, packed)
    assert bj.route(mode, f, V, H) == ("padded" if mode == "auto" else mode)

    jf, jg, jys, jxn, jyn = (jnp.asarray(t.numpy()) for t in (f, g, ys, xn, yn))
    loss_fn = _jax_loss_fn(mode, JaxJoint(vocab_size=V, hidden=H), jys,
                           np.asarray(jxn), np.asarray(jyn), T, U)
    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree), jf, jg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    for layer in ("pre", "out"):
        for name in ("kernel", "bias"):
            got = grads[layer][name].numpy()
            want = np.asarray(jgrads["params"][layer][name])
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(
                got, want, rtol=5e-2, atol=max(2e-2 * np.abs(want).max(), 1e-6),
                err_msg=f"{mode} {layer}/{name}")


def test_joint_tree_is_flax_lecun_normal():
    """Truncated at two standard deviations of the untruncated normal,
    variance 1 / fan_in, zero biases; Flax's Joint layout."""
    H, V = 256, 5000
    tree = bj.joint_tree(0, H, V)["params"]
    k = tree["out"]["kernel"]
    assert k.shape == (H, V) and tree["pre"]["kernel"].shape == (H, H)
    assert not tree["out"]["bias"].any() and not tree["pre"]["bias"].any()
    std = H ** -0.5 / 0.87962566103423978
    assert np.abs(k).max() <= 2 * std
    np.testing.assert_allclose(k.var(), 1 / H, rtol=0.02)


def test_bench_joint_needs_cuda():
    _no_cuda()
    with pytest.raises(SystemExit, match="CUDA device"):
        bj.bench_joint(N=2, T=6, U=3, V=12, H=16, mode="fused")


# ---- bench_decode_traffic ---------------------------------------------------


def test_decode_traffic_requests():
    reqs = bdt.requests(0, bdt.REQUESTS, device="cpu")
    again = bdt.requests(0, bdt.REQUESTS, device="cpu")
    assert len(reqs) == bdt.REQUESTS
    for (f, xn), (f2, xn2) in zip(reqs, again):
        N, T, F = f.shape
        assert N in bdt.BATCHES and bdt.T_MIN <= T <= bdt.T_MAX
        assert F == bdt.F and f.dtype == torch.float32
        assert xn.shape == (N,) and xn.dtype == torch.int32
        assert int(xn[0]) == T and bool(((xn >= T // 2) & (xn <= T)).all())
        assert torch.equal(f, f2) and torch.equal(xn, xn2)
    assert len({tuple(f.shape[:2]) for f, _ in reqs}) > 1


def test_decode_traffic_needs_cuda():
    _no_cuda()
    with pytest.raises(SystemExit, match="CUDA device"):
        bdt.bench_traffic(0, 2)
