"""The compact (packed) loss under a compiled step
(`warp_rnnt_tpu_torch/functional/compact.py`: JAX's jitted compact loss
with static bounds), on the CPU, where a compiled step's trace runs
eagerly inside `utils.compiled_step._tracing`.

  * Traced, with ``max_frames`` and ``max_labels`` given, ``rnnt_loss(...,
    compact=True)`` and its backward read nothing on the host
    (``Tensor.cpu``, ``Tensor.tolist`` and ``Tensor.item`` patched to
    raise), equal the eager call bit for bit, and equal JAX's
    ``jax.jit(partial(rnnt_loss, compact=True, max_frames=T,
    max_labels=U))`` (``impl="scan"``): the costs at fp32 rtol 1e-5, the
    packed gradient within `tests/test_torch_compact.py`'s ``GRAD_TOL``
    (rtol 1e-4, atol 1e-5: the two packages' fp32 scans round differently,
    a few 1e-5 of relative error at T=40, U=12), on ragged
    lengths, bounds equal to the lengths' maxima and above them, pad rows,
    blank 3, FastEmit.  `rnnt_loss_compact_with_internals` traced equals
    it eagerly.
  * Traced, a bound missing raises JAX's message; a bound below a length
    is not checked: the lengths are clamped to the bounds, and the result
    is the eager call's on the clamped lengths.
  * Eager calls still raise every ValueError they raised; the checks of
    shapes and of the blank still raise traced.
  * `bench_joint`'s compact mode compiles (its check runs on the CPU),
    and the check that a compact step without bounds fails its capture
    runs on the CPU; `packed_step`'s compiled steps equal its eager ones.
The card's checks are in `tests/test_torch_compiled_train_card.py`.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
from warp_rnnt_tpu_torch.benchmarks import compiled_train_cases as ctc
from warp_rnnt_tpu_torch.benchmarks import packed_cases, packed_step
from warp_rnnt_tpu_torch.functional import compact
from warp_rnnt_tpu_torch.utils import compiled_step as cs

COST_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_compact.py
MESSAGE = "compact mode under jit requires static max_frames / max_labels"
CASES = ["generic ragged", "T spans many rows", "yn=0 sample", "T<U",
         "pad rows", "blank=3", "V=50"]


def _case(name, seed=3):
    xn, yn, V, pad, blank, dtype = packed_cases.CASES[name]
    case = packed_cases.make_case(xn, yn, V, pad, blank, dtype, seed, "cpu")
    case["xs"] = torch.log_softmax(case["xs"].float(), -1)
    return case


def _no_host_reads(monkeypatch):
    def read(*_, **__):
        raise AssertionError("a host read under a compiled step's trace")

    for name in ("cpu", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, read)


def _loss_grad(case, traced, w, **kw):
    x = case["xs"].clone().requires_grad_()
    args = (case["ys"], case["xn"], case["yn"])
    with cs._tracing() if traced else contextlib.nullcontext():
        out = wt.rnnt_loss(x, *args, compact=True, blank=case["blank"], **kw)
        (out * w).sum().backward()
    return out.detach(), x.grad


@pytest.mark.parametrize("above", [0, 2], ids=["tight", "above"])
@pytest.mark.parametrize("name", CASES)
def test_traced_compact_reads_nothing_and_matches_jax(name, above,
                                                      monkeypatch):
    case = _case(name)
    T, L = case["T"] + above, case["U"] - 1 + above
    w = torch.linspace(0.5, 1.5, case["xn"].shape[0])
    kw = dict(max_frames=T, max_labels=L,
              fastemit_lambda=0.3 if name == "generic ragged" else 0.0)
    eager = _loss_grad(case, False, w, **kw)
    xs_np, ys_np = case["xs"].numpy(), case["ys"].numpy()
    xn_np, yn_np = case["xn"].numpy(), case["yn"].numpy()
    with monkeypatch.context() as m:
        _no_host_reads(m)
        out, grad = _loss_grad(case, True, w, **kw)
    assert torch.equal(out, eager[0]) and torch.equal(grad, eager[1])

    loss = jax.jit(functools.partial(
        warp_rnnt_tpu.rnnt_loss, compact=True, blank=case["blank"],
        impl="scan", **kw))
    jargs = tuple(jnp.asarray(a) for a in (ys_np, xn_np, yn_np))
    jw = jnp.asarray(w.numpy())
    jcosts = np.asarray(loss(jnp.asarray(xs_np), *jargs))
    jgrad = np.asarray(jax.grad(lambda z: (loss(z, *jargs) * jw).sum())(
        jnp.asarray(xs_np)))
    np.testing.assert_allclose(out.numpy(), jcosts, rtol=COST_RTOL)
    np.testing.assert_allclose(grad.numpy(), jgrad, **GRAD_TOL)


@pytest.mark.parametrize("name", ["generic ragged", "pad rows", "blank=3"])
def test_traced_with_internals_equals_eager(name, monkeypatch):
    case = _case(name)
    args = (case["xs"], case["ys"], case["xn"], case["yn"])
    kw = dict(blank=case["blank"], max_frames=case["T"],
              max_labels=case["U"] - 1)
    want = compact.rnnt_loss_compact_with_internals(*args, **kw)
    with monkeypatch.context() as m:
        _no_host_reads(m)
        with cs._tracing():
            got = compact.rnnt_loss_compact_with_internals(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("missing", ["max_frames", "max_labels", "both"])
def test_traced_compact_needs_both_bounds(missing):
    case = _case("generic ragged")
    kw = {"max_frames": case["T"], "max_labels": case["U"] - 1}
    for k in ("max_frames", "max_labels"):
        if missing in (k, "both"):
            del kw[k]
    with cs._tracing(), pytest.raises(ValueError, match=MESSAGE):
        wt.rnnt_loss(case["xs"], case["ys"], case["xn"], case["yn"],
                     compact=True, **kw)


@pytest.mark.parametrize("which", ["frames", "labels", "both"])
def test_traced_bound_below_a_length_clamps(which):
    """Not checked under a trace, as under JAX's jit: the lengths are
    clamped on the device to the bounds, and the loss is the eager one of
    the clamped lengths (their rows laid out for them)."""
    case = _case("generic ragged")
    T = case["T"] - 3 if which in ("frames", "both") else case["T"]
    L = case["U"] - 2 if which in ("labels", "both") else case["U"] - 1
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    with cs._tracing():
        got = wt.rnnt_loss(xs, ys, xn, yn, compact=True, max_frames=T,
                           max_labels=L)
    want = wt.rnnt_loss(xs, ys, xn.clamp(0, T), yn.clamp(0, L), compact=True,
                        max_frames=T, max_labels=L)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    with pytest.raises(ValueError, match="is below max"):
        wt.rnnt_loss(xs, ys, xn, yn, compact=True, max_frames=T, max_labels=L)


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
def test_eager_compact_still_raises(case_name, match):
    """`tests/test_torch_compact.py::test_compact_validation`'s errors,
    eagerly; traced, the checks of shapes and of the blank (no host read)
    still raise."""
    case = _case("generic ragged")
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    kw = {"max_frames": 9, "max_labels": 4}
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
    if case_name in ("ndim", "ys_ndim", "blank"):
        with cs._tracing(), pytest.raises(ValueError, match=match):
            wt.rnnt_loss(xs, ys, xn, yn, compact=True, **kw)


def test_bench_joint_compact_compiles_on_cpu():
    case = csc.joint_case(3, 9, 4, 13, 16, rand_length=True, device="cpu")
    assert "compact" in csc.JOINT_MODES
    assert csc.check_joint("compact", *case, profile=True) == {}
    assert csc.check_compact_needs_bounds(*case) == MESSAGE


@pytest.mark.parametrize("name", ["generic ragged", "pad rows", "V=50"])
def test_packed_step_compiled_equals_eager_on_cpu(name):
    case = _case(name)
    assert packed_step.bounds(case) == {"max_frames": case["T"],
                                        "max_labels": case["U"] - 1}
    assert ctc.check_compact(case) == {}
