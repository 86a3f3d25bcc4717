"""Parity of the port's parallel tier (`warp_rnnt_tpu_torch/parallel/`) with
the JAX package's, on the CPU.

One module-scoped fixture runs three gloo worlds, one after the other
(`_torch_port_helpers.spawn_worlds` over `multihost.spawn`: ``file://``
rendezvous, 120 s a world, no worker left behind): a 1-D ('data',) world
of 4 processes, a 2x2 ('data', 'model') world, and 2 processes through
`multihost.initialize` (from the JAX module's environment variables) and
`global_batch`.  The JAX side runs here, on the 8 virtual devices of
`tests/conftest.py`, with ``impl="scan"``, on the same numpy inputs from
seeds.  Tolerances are the JAX tests': costs rtol 1e-5 atol 1e-6,
gradients rtol 1e-4 atol 1e-6.

  * `rnnt_loss_shard_map` none/sum/mean against JAX's shard_map and the
    unsharded loss (`tests/test_models_and_parallel.py:35-47`);
  * `rnnt_loss_sharded` loss and gradient (`:50-72`), also on ragged shards
    (1, 2, 3, 2 samples) with average_frames, where `rnnt_loss_shard_map`
    must raise;
  * log-probs sharded over ('data', 'model') (`:152-181`), blank 0 and
    blank 5 (in the second block only), against JAX's GSPMD call; the
    from-logits lattice (`vocab.vocab_lattice`) and the blockwise
    log_softmax against `rnnt_loss_from_logits` and `rnnt_loss`;
  * the compact layout with ragged lengths, rows split by sample, with the
    global lattice bounds given and left to `rnnt_loss_sharded`;
  * the restricted loss with one infeasible band on rank 1: +inf and zero
    gradients under "none", the global feasible-only mean;
  * 2 processes against the NumPy oracle (`tests/distributed_worker.py`),
    and a rank with other shapes raising on both;
  * a vocabulary that does not divide over 'model' raising ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import golden
from _torch_port_helpers import loss_inputs, spawn_worlds, world
from warp_rnnt_tpu import rnnt_loss as jax_rnnt_loss
from warp_rnnt_tpu.functional.from_logits import rnnt_loss_from_logits
from warp_rnnt_tpu.functional.restricted import rnnt_loss_restricted
from warp_rnnt_tpu.parallel import rnnt_loss_shard_map as jax_shard_map
from warp_rnnt_tpu.reference.numpy_oracle import transduce_batch
from warp_rnnt_tpu_torch.parallel import multihost, vocab

COST = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
REDUCTIONS = ("none", "sum", "mean")
RAGGED_SPLIT = [1, 2, 3, 2]
BAD_SAMPLE = 2  # infeasible band, on rank 1 of the 1-D world
CONTEXTS = (2, 2)


def _random_batch(seed, N, T, U, V, blank=0):
    """`tests/test_models_and_parallel.py`'s batch (labels avoid the
    blank)."""
    rng = np.random.RandomState(seed)
    xs = golden.log_softmax(rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    ys = np.where(ys <= blank, ys - 1, ys).astype(np.int32)
    xn = np.full((N,), T, np.int32)
    yn = rng.randint(1, U, size=(N,)).astype(np.int32)
    return xs, ys, xn, yn


def _packed(seed, N=8, T=9, U=5, V=6, pad=3):
    """A ragged packed batch: (xs (rows, V), ys (sum(yn),), xn, yn)."""
    xs, ys, xn, yn = loss_inputs(seed, N, T, U, V)
    rng = np.random.RandomState(seed + 100)
    rows = [xs[i, :xn[i], :yn[i] + 1].reshape(-1, V) for i in range(N)]
    rows.append(golden.log_softmax(rng.randn(pad, V)).astype(np.float32))
    labels = np.concatenate([ys[i, :yn[i]] for i in range(N)]).astype(np.int32)
    return np.concatenate(rows), labels, xn, yn


def _restricted(seed, N=8, T=10, U=4, V=6):
    """Ragged log-probs with sorted label frames inside each sample, and
    BAD_SAMPLE's band out of order (every path pruned)."""
    xs, ys, xn, yn = loss_inputs(seed, N, T, U, V)
    xn[BAD_SAMPLE], yn[BAD_SAMPLE] = T, U - 1
    rng = np.random.RandomState(seed + 100)
    lf = np.stack([np.sort(rng.randint(0, xn[i], size=U - 1))
                   for i in range(N)]).astype(np.int32)
    lf[BAD_SAMPLE] = [T - 1, 0, 0]
    return xs, ys, xn, yn, lf


def _multihost_batch():
    """`tests/distributed_worker.py`'s batch for 2 processes."""
    rng = np.random.RandomState(0)
    N, T, U, V = 8, 12, 4, 6
    logits = rng.randn(N, T, U, V).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    xn = rng.randint(T - 3, T + 1, size=(N,)).astype(np.int32)
    yn = rng.randint(1, U, size=(N,)).astype(np.int32)
    return lp, ys, xn, yn


def _inputs():
    logits = np.random.RandomState(4).randn(8, 10, 4, 8).astype(np.float32)
    _, ys, xn, yn = _random_batch(4, 8, 10, 4, 8)
    return {
        "shard_map": _random_batch(0, 8, 12, 5, 7),
        "sharded": _random_batch(1, 8, 10, 4, 6),
        "ragged": loss_inputs(5, 8, 11, 5, 7), "ragged_split": RAGGED_SPLIT,
        "compact": _packed(6), "compact_bounds": (9, 4),
        "restricted": _restricted(7), "restricted_contexts": CONTEXTS,
        "vocab": _random_batch(2, 8, 10, 4, 8), "vocab_blank": 0,
        "vocab_blank5": _random_batch(3, 8, 10, 4, 8, blank=5),
        "vocab_blank5_blank": 5,
        "logits": (logits, ys, xn, yn),
        "multihost": _multihost_batch(),
    }


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inp = _inputs()
    out = tmp_path_factory.mktemp("torch_parallel")
    return inp, spawn_worlds(out, inp, {"data4": 4, "grid": 4,
                                        "multihost": 2})


def _jax_value_and_grad(fn, x, reduction):
    """JAX's loss and the gradient of its sum at x."""
    val = fn(jnp.asarray(x), reduction)
    grad = jax.grad(lambda z: jnp.sum(fn(z, reduction)))(jnp.asarray(x))
    return np.asarray(val), np.asarray(grad)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_shard_map_matches_jax(results, reduction):
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn = (jnp.asarray(a) for a in inp["shard_map"])
    ref = np.asarray(jax_rnnt_loss(xs, ys, xn, yn, reduction=reduction,
                                   impl="scan"))
    jmesh = _mesh((4,), ("data",))
    jsm = np.asarray(jax_shard_map(jmesh, xs, ys, xn, yn, reduction=reduction,
                                   impl="scan"))
    if reduction == "none":
        got = np.concatenate([r["shard_map"]["none"] for r in ranks])
    else:
        got = ranks[0]["shard_map"][reduction]
        for r in ranks[1:]:
            assert r["shard_map"][reduction] == got
    np.testing.assert_allclose(got, ref, **COST)
    np.testing.assert_allclose(got, jsm, **COST)


def test_sharded_loss_and_grad_match_jax(results):
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn = inp["sharded"]
    val, grad = _jax_value_and_grad(
        lambda z, red: jax_rnnt_loss(z, ys, xn, yn, reduction=red,
                                     impl="scan"), xs, "mean")
    for r in ranks:
        np.testing.assert_allclose(r["sharded"]["loss"], val, **COST)
    np.testing.assert_allclose(
        np.concatenate([r["sharded"]["grad"] for r in ranks]), grad, **GRAD)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_sharded_ragged_shards_match_jax(results, reduction):
    """Shards of 1, 2, 3 and 2 samples, average_frames: the global sum and
    the global mean, as one process gives them."""
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn = inp["ragged"]
    val, grad = _jax_value_and_grad(
        lambda z, red: jax_rnnt_loss(z, ys, xn, yn, reduction=red,
                                     average_frames=True, impl="scan"),
        xs, reduction)
    for r in ranks:
        np.testing.assert_allclose(r["ragged"][reduction]["loss"], val, **COST)
    np.testing.assert_allclose(
        np.concatenate([r["ragged"][reduction]["grad"] for r in ranks]), grad,
        **GRAD)


def test_shard_map_refuses_ragged_shards(results):
    for r in world(results[1], "data4"):
        kind, name, msg = r["ragged_shard_map"]
        assert (kind, name) == ("raised", "ValueError")
        assert "does not divide evenly over 'data'" in msg and "1 to 3" in msg


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_compact_ragged_split_by_sample_matches_jax(results, reduction):
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn = inp["compact"]
    T, L = inp["compact_bounds"]
    val, grad = _jax_value_and_grad(
        lambda z, red: jax_rnnt_loss(z, ys, xn, yn, reduction=red,
                                     compact=True, impl="scan", max_frames=T,
                                     max_labels=L), xs, reduction)
    case = [r["compact"][reduction] for r in ranks]
    got = (np.concatenate([c["loss"] for c in case]) if reduction == "none"
           else case[0]["loss"])
    np.testing.assert_allclose(got, val, **COST)
    valid = int((xn * (yn + 1)).sum())
    np.testing.assert_allclose(np.concatenate([c["grad"] for c in case]),
                               grad[:valid], **GRAD)
    assert not grad[valid:].any()


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_compact_without_bounds_takes_the_global_ones(results, reduction):
    """No max_frames/max_labels: `rnnt_loss_sharded` takes the global
    batch's, though some rank's own samples are shorter, and matches the
    single-process JAX call without bounds."""
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn = inp["compact"]
    own = [(xn[2 * r:2 * r + 2].max(), yn[2 * r:2 * r + 2].max())
           for r in range(4)]
    assert any(b != (xn.max(), yn.max()) for b in own)
    val, grad = _jax_value_and_grad(
        lambda z, red: jax_rnnt_loss(z, ys, xn, yn, reduction=red,
                                     compact=True, impl="scan"),
        xs, reduction)
    case = [r["compact_global_bounds"][reduction] for r in ranks]
    got = (np.concatenate([c["loss"] for c in case]) if reduction == "none"
           else case[0]["loss"])
    np.testing.assert_allclose(got, val, **COST)
    valid = int((xn * (yn + 1)).sum())
    np.testing.assert_allclose(np.concatenate([c["grad"] for c in case]),
                               grad[:valid], **GRAD)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_restricted_infeasible_band_on_one_rank_matches_jax(results, reduction):
    """Rank 1 holds the infeasible sample: "mean" divides by the global
    count of feasible samples (7), not a mean of the ranks' means."""
    inp, res = results
    ranks = world(res, "data4")
    xs, ys, xn, yn, lf = inp["restricted"]
    left, right = inp["restricted_contexts"]
    val, grad = _jax_value_and_grad(
        lambda z, red: rnnt_loss_restricted(
            z, ys, xn, yn, lf, left_context=left, right_context=right,
            reduction=red, impl="scan"), xs, reduction)
    case = [r["restricted"][reduction] for r in ranks]
    if reduction == "none":
        got = np.concatenate([c["loss"] for c in case])
        assert np.isposinf(got[BAD_SAMPLE]) and np.isposinf(val[BAD_SAMPLE])
        assert np.isfinite(np.delete(got, BAD_SAMPLE)).all()
    else:
        got = case[0]["loss"]
        for c in case[1:]:
            assert c["loss"] == got
    np.testing.assert_allclose(got, val, **COST)
    g = np.concatenate([c["grad"] for c in case])
    np.testing.assert_allclose(g, grad, **GRAD)
    assert not g[BAD_SAMPLE].any()
    if reduction == "mean":
        costs = np.concatenate([c["loss"] for c in (
            r["restricted"]["none"] for r in ranks)])
        feasible = np.isfinite(costs)
        np.testing.assert_allclose(got, costs[feasible].sum() / feasible.sum(),
                                   **COST)


def _grid_grad(ranks, case, reduction):
    """The (N, T, U, V) gradient from the 2x2 ranks' blocks: rank d*2 + m
    holds samples [4d, 4d+4) and columns [V/2 m, V/2 (m+1))."""
    blocks = [[ranks[2 * d + m][case][reduction]["grad"] for m in (0, 1)]
              for d in (0, 1)]
    return np.concatenate([np.concatenate(b, axis=-1) for b in blocks])


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("case", ["vocab", "vocab_blank5"])
def test_vocab_sharded_loss_and_grad_match_jax(results, case, reduction):
    inp, res = results
    ranks = world(res, "grid")
    xs, ys, xn, yn = inp[case]
    blank = inp[f"{case}_blank"]
    jmesh = _mesh((2, 2), ("data", "model"))
    xs_sh = jax.device_put(jnp.asarray(xs),
                           NamedSharding(jmesh, P("data", None, None, "model")))
    ys_sh = jax.device_put(jnp.asarray(ys), NamedSharding(jmesh, P("data", None)))

    def fn(z, red):
        return jax_rnnt_loss(z, ys_sh, xn, yn, reduction=red, blank=blank,
                             impl="scan")

    val = np.asarray(jax.jit(lambda z: fn(z, reduction))(xs_sh))
    grad = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(fn(z, reduction))))(xs_sh))
    if reduction == "none":
        got = np.concatenate([ranks[0][case]["none"]["loss"],
                              ranks[2][case]["none"]["loss"]])
        for d in (0, 2):
            assert np.array_equal(ranks[d][case]["none"]["loss"],
                                  ranks[d + 1][case]["none"]["loss"])
    else:
        got = ranks[0][case][reduction]["loss"]
        for r in ranks:
            assert r[case][reduction]["loss"] == got
    np.testing.assert_allclose(got, val, **COST)
    np.testing.assert_allclose(_grid_grad(ranks, case, reduction), grad, **GRAD)


@pytest.mark.parametrize("normalize", [False, True], ids=["from_logits",
                                                          "log_softmax"])
def test_vocab_sharded_logits_match_jax(results, normalize):
    """Raw logits over ('data', 'model'): the from-logits lattice (the
    vocabulary-parallel logsumexp and gather) against
    `rnnt_loss_from_logits`, and the blockwise log_softmax against
    `rnnt_loss` of JAX's log_softmax (its gradient through
    `vocab.copy_to_model`)."""
    inp, res = results
    ranks = world(res, "grid")
    z, ys, xn, yn = inp["logits"]
    if normalize:
        def fn(x, red):
            return jax_rnnt_loss(jax.nn.log_softmax(x, -1), ys, xn, yn,
                                 reduction=red, impl="scan")
    else:
        def fn(x, red):
            return rnnt_loss_from_logits(x, ys, xn, yn, reduction=red,
                                         impl="scan")
    val, grad = _jax_value_and_grad(fn, z, "mean")
    key = "log_softmax" if normalize else "from_logits"
    for r in ranks:
        np.testing.assert_allclose(r[key]["loss"], val, **COST)
    blocks = [np.concatenate([ranks[2 * d + m][key]["grad"] for m in (0, 1)],
                             axis=-1) for d in (0, 1)]
    np.testing.assert_allclose(np.concatenate(blocks), grad, **GRAD)


def test_nondivisible_vocab_raises(results):
    for r in world(results[1], "grid"):
        kind, name, msg = r["nondivisible"]
        assert (kind, name) == ("raised", "ValueError")
        assert "vocabulary of 7 does not divide over the 2 ranks" in msg
    with pytest.raises(ValueError, match="does not divide over the 3 ranks"):
        vocab.vocab_block(1024, 3, 0)


def test_two_process_global_batch_matches_numpy_oracle(results):
    """`tests/distributed_worker.py` on the port: each process passes its
    half through `global_batch`, the shard_map mean equals the oracle's."""
    inp, res = results
    ranks = world(res, "multihost")
    costs, _, _, _ = transduce_batch(*inp["multihost"])
    for r in ranks:
        assert abs(float(r["loss"]) - float(np.mean(costs))) < 1e-4


def test_global_batch_refuses_other_shapes(results):
    for r in world(results[1], "multihost"):
        kind, name, msg = r["shapes_differ"]
        assert (kind, name) == ("raised", "ValueError")
        assert "shapes differ across ranks" in msg


def test_backend_follows_the_device_without_fallback(monkeypatch):
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for("cuda:1") == "nccl"
    assert multihost.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        multihost.backend_for("cpu", "nccl")
    monkeypatch.delenv("WARP_RNNT_NUM_PROCESSES", raising=False)
    multihost.initialize()  # one process: nothing to start
    assert not torch.distributed.is_initialized()


def test_parallel_exports_match_jax():
    import warp_rnnt_tpu.parallel as jp
    import warp_rnnt_tpu_torch.parallel as tp

    assert tp.__all__ == jp.__all__
    assert all(callable(getattr(tp, name)) for name in tp.__all__)
