"""Parity of the port's TensorFlow front end (`warp_rnnt_tpu_torch.bindings.
tf_binding`, the DLPack bridge into the port) with the JAX package's TF
front end and its functional counterparts, on the CPU.

Inputs are made from numpy seeds; both front ends take the same TF tensors.
  * the golden vectors through `GradientTape`, ``graph=False``: rtol 1e-4,
    atol 2e-5 (`tests/test_tf_binding.py`);
  * against JAX's `rnnt_loss(graph=False)` (its bridge) and
    `rnnt_loss(graph=True)` (its jax2tf op): ragged lengths, blank 0 and
    V-1, FastEmit 0 and 0.3, every reduction with and without
    `average_frames`, gradients under a per-sample upstream: costs rtol
    1e-5, gradients within 1e-4 of the largest entry;
  * the TF gather (`gather_log_probs` exactly as JAX's; ``gather=True``),
    the pre-gathered ``blank=-1`` sentinel (costs and the (N, T, U, 2)
    gradient), a plain `tf.function`, large V;
  * ``graph=True`` and `transducer_loss_graph` raise NotImplementedError,
    naming ``graph=False``;
  * the fused and routed joint losses, gradients to f, g and the four
    parameters as tensors and as `tf.Variable`s, against JAX's
    `rnnt_loss_fused_joint` and `rnnt_loss_joint` under
    `jax.value_and_grad`: costs rtol 2e-3, gradients as
    `tests/test_torch_fused_joint.py` (`WRAPPER_TOL`) and
    `tests/test_torch_joint_loss.py` (2e-2 of the largest) state them;
  * the bridge's torch half (`bindings._bridge`) against
    `rnnt_loss_with_internals`, and `benchmarks/bridge_cases.py`'s checks
    (`chip_smoke.py` phase 18) on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import golden  # noqa: E402
import warp_rnnt_tpu  # noqa: E402
from _torch_port_helpers import loss_inputs, tt  # noqa: E402
from warp_rnnt_tpu.bindings import tf_binding as jtf  # noqa: E402
from warp_rnnt_tpu.ops import fused_joint as jfj  # noqa: E402
from warp_rnnt_tpu_torch.benchmarks import bridge_cases as bc  # noqa: E402
from warp_rnnt_tpu_torch.bindings import _bridge  # noqa: E402
from warp_rnnt_tpu_torch.bindings import tf_binding as ptf  # noqa: E402
from warp_rnnt_tpu_torch.functional.loss import (  # noqa: E402
    rnnt_loss_with_internals,
)

WRAPPER_TOL = dict(rtol=0.1, rel_atol=2e-2)   # test_torch_fused_joint.py:53
JOINT_TOL = dict(rtol=0.0, rel_atol=2e-2)     # test_torch_joint_loss.py:103


def _t(case):
    return (tf.constant(np.asarray(case["xs"]), tf.float32),
            tf.constant(case["ys"], tf.int32),
            tf.constant(case["xn"], tf.int32),
            tf.constant(case["yn"], tf.int32))


def _loss_and_grad(fn, xs, *args, weights=None, **kw):
    """Costs (or the reduced loss) and the gradient w.r.t. xs of their
    weighted sum (``weights`` per sample; the loss itself when reduced)."""
    with tf.GradientTape() as tape:
        tape.watch(xs)
        out = fn(xs, *args, **kw)
        total = tf.reduce_sum(out * weights) if weights is not None and \
            out.shape.rank == 1 else tf.reduce_sum(out)
    return out.numpy(), tape.gradient(total, xs).numpy()


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(golden.ALL_PADDED_CASES))
def test_golden_with_gradient(name):
    case = golden.ALL_PADDED_CASES[name]
    costs, grads = _loss_and_grad(ptf.rnnt_loss, *_t(case), graph=False)
    np.testing.assert_allclose(costs, case["expected_costs"], rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(grads, case["expected_grads"], rtol=1e-4,
                               atol=2e-5)


def _ragged(blank_last, seed=11, N=4, T=9, U=5, V=13):
    """Ragged log-probs; with ``blank_last`` the blank is V-1 and the labels
    avoid it."""
    xs, ys, xn, yn = loss_inputs(seed, N=N, T=T, U=U, V=V)
    blank = V - 1 if blank_last else 0
    if blank_last:
        ys = np.where(ys == blank, 1, ys).astype(np.int32)
    return (tf.constant(xs), tf.constant(ys), tf.constant(xn),
            tf.constant(yn), blank)


@pytest.mark.parametrize("average_frames", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("fastemit", [0.0, 0.3])
@pytest.mark.parametrize("blank_last", [False, True])
def test_bridge_matches_jax_tf(blank_last, fastemit, reduction,
                               average_frames):
    """The port's bridge against JAX's bridge and JAX's graph op."""
    xs, ys, xn, yn, blank = _ragged(blank_last)
    weights = tf.constant([0.3, 1.7, 0.9, 1.2], tf.float32)
    kw = dict(blank=blank, fastemit_lambda=fastemit, reduction=reduction,
              average_frames=average_frames, weights=weights)
    got = _loss_and_grad(ptf.rnnt_loss, xs, ys, xn, yn, graph=False, **kw)
    for graph in (False, True):
        want = _loss_and_grad(jtf.rnnt_loss, xs, ys, xn, yn, graph=graph, **kw)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                   err_msg=f"JAX graph={graph}")
        _grad_close(got[1], want[1])


def test_gather_log_probs_matches_jax():
    xs, ys, _, _, _ = _ragged(False)
    for blank in (0, 12):
        np.testing.assert_array_equal(
            ptf.gather_log_probs(xs, ys, blank).numpy(),
            jtf.gather_log_probs(xs, ys, blank).numpy())


@pytest.mark.parametrize("blank_last", [False, True])
def test_inner_gather(blank_last):
    """gather=True gathers in TF and takes the bridge pre-gathered: the
    same costs and dense gradient as JAX's bridge."""
    xs, ys, xn, yn, blank = _ragged(blank_last, seed=12)
    weights = tf.constant([1.1, 0.4, 2.0, 0.7], tf.float32)
    got = _loss_and_grad(ptf.rnnt_loss, xs, ys, xn, yn, blank=blank,
                         gather=True, graph=False, weights=weights)
    want = _loss_and_grad(jtf.rnnt_loss, xs, ys, xn, yn, blank=blank,
                          gather=True, graph=False, weights=weights)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _grad_close(got[1], want[1])


def test_pregathered_sentinel():
    """blank=-1: a pre-gathered (N, T, U, 2) lattice, its costs and its
    (N, T, U, 2) gradient, against JAX's bridge and the golden costs."""
    case = golden.FORWARD_BATCH
    xs, ys, xn, yn = _t(case)
    lat = ptf.gather_log_probs(xs, ys)
    weights = tf.constant([0.5, 1.5], tf.float32)
    got = _loss_and_grad(ptf.rnnt_loss, lat, ys, xn, yn, blank=-1,
                         graph=False, weights=weights)
    want = _loss_and_grad(jtf.rnnt_loss, lat, ys, xn, yn, blank=-1,
                          graph=False, weights=weights)
    assert got[1].shape == tuple(lat.shape)
    np.testing.assert_allclose(got[0], case["expected_costs"], rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _grad_close(got[1], want[1])


def test_inside_tf_function():
    """In a plain tf.function: the mean loss and its gradient."""
    case = golden.FORWARD_BATCH
    xs, ys, xn, yn = _t(case)

    @tf.function
    def f(x):
        with tf.GradientTape() as tape:
            tape.watch(x)
            loss = ptf.rnnt_loss(x, ys, xn, yn, reduction="mean", graph=False)
        return loss, tape.gradient(loss, x)

    loss, grads = f(xs)
    np.testing.assert_allclose(float(loss), np.mean(case["expected_costs"]),
                               rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(),
                               np.asarray(case["expected_grads"]) / 2,
                               rtol=1e-4, atol=2e-5)


def test_large_vocab():
    """N=2, T=6, U=4, V=300 (`tests/test_tf_binding.py`'s large-V case):
    the bridge against JAX's graph op and JAX's bridge."""
    rng = np.random.RandomState(1)
    N, T, U, V = 2, 6, 4, 300
    x = rng.randn(N, T, U, V).astype(np.float32)
    x = x - np.log(np.sum(np.exp(x), axis=-1, keepdims=True))
    ys = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.full((N,), T, np.int32)
    yn = np.full((N,), U - 1, np.int32)
    weights = tf.constant([0.8, 1.3], tf.float32)
    got = _loss_and_grad(ptf.rnnt_loss, tf.constant(x), ys, xn, yn,
                         graph=False, weights=weights)
    for graph in (False, True):
        want = _loss_and_grad(jtf.rnnt_loss, tf.constant(x), ys, xn, yn,
                              graph=graph, weights=weights)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        _grad_close(got[1], want[1])


def test_graph_path_raises():
    """graph=True (the default) and transducer_loss_graph name the bridge;
    the call never takes it quietly."""
    xs, ys, xn, yn = _t(golden.FORWARD_BATCH)
    with pytest.raises(NotImplementedError, match="graph=False"):
        ptf.rnnt_loss(xs, ys, xn, yn)
    with pytest.raises(NotImplementedError, match="graph=False"):
        ptf.transducer_loss_graph(xs, ys, xn, yn)


def test_unknown_reduction_and_assertions():
    xs, ys, xn, yn = _t(golden.FORWARD_BATCH)
    with pytest.raises(AssertionError):
        ptf.rnnt_loss(xs, ys, xn, yn, reduction="max", graph=False)
    with pytest.raises(AssertionError):
        ptf.rnnt_loss(xs, ys, xn, yn, blank=0.0, graph=False)
    costs = ptf.transducer_loss(xs, ys, xn, yn)
    with pytest.raises(ValueError, match="Unknown reduction method: max"):
        ptf._reduce(costs, xn, False, "max")


# ---- the fused and routed joint losses -----------------------------------


def _joint_case(mode, seed=5):
    """`tests/test_tf_binding.py`'s joint shape, N=2, T=8, U=4, F=10, H=16,
    V=21, ragged, as numpy."""
    rng = np.random.RandomState(seed)
    N, T, U, F, H, V = 2, 8, 4, 10, 16, 21
    f = rng.randn(N, T, F).astype(np.float32) * 0.3
    g = rng.randn(N, U, F).astype(np.float32) * 0.3
    fin = 2 * F if mode == "concat" else F
    params = {"w_pre": rng.randn(fin, H).astype(np.float32) * 0.2,
              "b_pre": rng.randn(H).astype(np.float32) * 0.1,
              "w_out": rng.randn(H, V).astype(np.float32) * 0.2,
              "b_out": rng.randn(V).astype(np.float32) * 0.1}
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([T, T - 2], np.int32)
    yn = np.array([U - 1, 2], np.int32)
    return f, g, params, labels, xn, yn


NAMES = ("f", "g", *_bridge.JOINT_PARAMS)


def _tf_joint(fn, case, variables, weights, **kw):
    f, g, params, labels, xn, yn = case
    make = tf.Variable if variables else tf.constant
    ft, gt = make(f), make(g)
    pt = {k: make(v) for k, v in params.items()}
    leaves = [ft, gt, *(pt[k] for k in _bridge.JOINT_PARAMS)]
    with tf.GradientTape() as tape:
        if not variables:
            tape.watch(leaves)
        out = fn(ft, gt, pt, tf.constant(labels), tf.constant(xn),
                 tf.constant(yn), **kw)
        total = tf.reduce_sum(out * weights) if out.shape.rank == 1 else out
    grads = tape.gradient(total, leaves)
    return out.numpy(), dict(zip(NAMES, (d.numpy() for d in grads)))


def _jax_joint(fn, case, weights, **kw):
    f, g, params, labels, xn, yn = case

    def loss(jf, jg, jp):
        o = fn(jf, jg, jp, jnp.asarray(labels), xn, yn, impl="scan", **kw)
        return ((o * weights).sum() if o.ndim == 1 else o), o

    (_, out), (gf, gg, gp) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(f), jnp.asarray(g),
        {k: jnp.asarray(v) for k, v in params.items()})
    grads = {"f": gf, "g": gg, **gp}
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("variables", [False, True])
@pytest.mark.parametrize("mode", ["add", "concat"])
@pytest.mark.parametrize("kind", ["fused", "routed"])
def test_joint_losses_match_jax(kind, mode, variables):
    """Costs under 'none' and the gradients of a per-sample weighted sum, to
    f, g and the four parameters, as tensors and as variables."""
    case = _joint_case(mode)
    weights = np.array([0.6, 1.4], np.float32)
    fn = {"fused": ptf.rnnt_loss_fused_joint, "routed": ptf.rnnt_loss_joint}
    jfn = {"fused": jfj.rnnt_loss_fused_joint,
           "routed": warp_rnnt_tpu.rnnt_loss_joint}
    costs, grads = _tf_joint(fn[kind], case, variables,
                             tf.constant(weights), mode=mode)
    jcosts, jgrads = _jax_joint(jfn[kind], case, weights, mode=mode)
    np.testing.assert_allclose(costs, jcosts, rtol=2e-3)
    tol = WRAPPER_TOL if kind == "fused" else JOINT_TOL
    for name in NAMES:
        got, want = grads[name], jgrads[name]
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(
            got, want, rtol=tol["rtol"],
            atol=max(tol["rel_atol"] * np.abs(want).max(), 1e-5),
            err_msg=f"{kind} {mode} {name}")


@pytest.mark.parametrize("average_frames", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_joint_reductions_match_jax(reduction, average_frames):
    """The fused joint's reductions and frame averaging in TF, against JAX's
    same call."""
    case = _joint_case("add", seed=6)
    weights = np.array([1.3, 0.5], np.float32)
    kw = dict(reduction=reduction, average_frames=average_frames)
    costs, grads = _tf_joint(ptf.rnnt_loss_fused_joint, case, False,
                             tf.constant(weights), **kw)
    jcosts, jgrads = _jax_joint(jfj.rnnt_loss_fused_joint, case, weights, **kw)
    np.testing.assert_allclose(costs, jcosts, rtol=2e-3)
    for name in NAMES:
        np.testing.assert_allclose(
            grads[name], jgrads[name], rtol=WRAPPER_TOL["rtol"],
            atol=max(2e-2 * np.abs(jgrads[name]).max(), 1e-5), err_msg=name)


def test_joint_inside_tf_function():
    """The two py_functions (forward, and the backward's second forward)
    inside a plain tf.function give the eager results."""
    case = _joint_case("add", seed=7)
    f, g, params, labels, xn, yn = case
    weights = tf.constant([0.9, 1.1])
    eager = _tf_joint(ptf.rnnt_loss_fused_joint, case, True, weights)
    pv = {k: tf.Variable(v) for k, v in params.items()}
    fv = tf.Variable(f)

    @tf.function
    def step():
        with tf.GradientTape() as tape:
            out = ptf.rnnt_loss_fused_joint(fv, tf.constant(g), pv, labels,
                                            xn, yn)
            total = tf.reduce_sum(out * weights)
        return out, tape.gradient(total, [fv, pv["w_out"]])

    out, (df, dw) = step()
    np.testing.assert_array_equal(out.numpy(), eager[0])
    np.testing.assert_array_equal(df.numpy(), eager[1]["f"])
    np.testing.assert_array_equal(dw.numpy(), eager[1]["w_out"])


# ---- the bridge's torch half ---------------------------------------------


@pytest.mark.parametrize("blank", [0, -1, 6])
def test_bridge_torch_half_matches_internals(blank):
    """`transducer_costs_and_grads` takes any integer dtype and gives the
    costs and gradients of `rnnt_loss_with_internals` exactly."""
    xs, ys, xn, yn = loss_inputs(13, N=3, T=7, U=4, V=9)
    xs_t = torch.tensor(xs)
    if blank == -1:
        xs_t = bc.pregathered(xs_t, torch.tensor(ys))
    costs, grads = _bridge.transducer_costs_and_grads(
        xs_t, *(torch.tensor(a, dtype=torch.int64) for a in (ys, xn, yn)),
        blank=blank, fastemit_lambda=0.2)
    want = rnnt_loss_with_internals(xs_t, *tt(ys, xn, yn), blank=blank,
                                    fastemit_lambda=0.2)
    assert costs.dtype == torch.float32 and grads.dtype == xs_t.dtype
    torch.testing.assert_close(costs, want[0], rtol=0, atol=0)
    torch.testing.assert_close(grads, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("blank", [0, -1])
def test_bridge_cases_on_cpu(blank):
    """Phase 18's checks on CPU tensors: the torch half against the plain
    version and the direct loss+grad, the TF bridge against the direct
    loss+grad, bit for bit."""
    xs, ys, xn, yn = (torch.tensor(a) for a in loss_inputs(14, N=3, T=8,
                                                           U=4, V=11))
    errs, launches = bc.check_bridge(xs, ys, xn, yn, blank=blank)
    assert errs["direct"] == 0.0 and launches == {}
    errs, _ = bc.check_tf_bridge(tf, ptf, xs, ys, xn, yn, blank=blank)
    assert errs == {"direct": 0.0}


@pytest.mark.parametrize("kind", ["fused", "routed"])
def test_tf_joint_case_on_cpu(kind):
    f, g, params, labels, xn, yn = (
        {k: torch.tensor(v) for k, v in x.items()} if isinstance(x, dict)
        else torch.tensor(x) for x in _joint_case("add", seed=8))
    weights = [params[k] for k in _bridge.JOINT_PARAMS]
    errs, _ = bc.check_tf_joint(tf, ptf, f, g, weights, labels, xn, yn, kind)
    assert errs == {"direct": 0.0}
