"""The compiled step (`warp_rnnt_tpu_torch/utils/compiled_step.py`, the
port's ``jax.jit`` with ``donate_argnums``) and its donated gradient
write, on the CPU.

  * On the CPU a compiled step runs its function eagerly: the loss+grad
    through it equals a direct `rnnt_loss` + backward bit for bit, and
    both equal JAX's ``jax.jit(jax.value_and_grad(...))`` with
    ``impl="scan"`` on the same numpy-seeded inputs (costs rtol 1e-5,
    gradients within 5e-3 of the largest), for each reduction,
    ``average_frames``, FastEmit, fp32 and bf16, 4-D and flat.
  * `flat_grad_write(..., out=)` and its plain twin fill the given buffer
    and equal the allocating call bit for bit; a wrong ``out`` raises.
  * The donated route (a buffer marked as a compiled step's trace marks
    it): the gradient's ``data_ptr`` is the log-probs', the values are the
    undonated route's; a mark is taken once; eager calls allocate.
  * The cache key separates shapes, dtypes, ``requires_grad``, flags,
    modes, donation, the debug canary and the caller's key.
  * The debug canary: inside a trace it reads nothing and registers a
    check that warns after the replay; eager (the CPU) it warns at once.
  * The benchmarks' compiled calls on the CPU are the eager ones.
The card's checks (compiled against eager bit for bit, zero copies in a
donated chain) are in `tests/test_torch_compiled_card.py`.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import loss_inputs, tt
import warp_rnnt_tpu
import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks import compiled_cases as cc
from warp_rnnt_tpu_torch.benchmarks import host_path, timing
from warp_rnnt_tpu_torch.ops import flat_kernels
from warp_rnnt_tpu_torch.utils import compiled_step as cs

COST_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_SHARE = 5e-3
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(layout, dtype, seed=20):
    xs, ys, xn, yn = loss_inputs(seed)
    N, T, U, V = xs.shape
    lp = xs.reshape(N, T, U * V) if layout == "flat" else xs
    return lp, ys, xn, yn


def _jax_loss_grad(lp, ys, xn, yn, jdtype, kw):
    def f(z):
        o = warp_rnnt_tpu.rnnt_loss(z, jnp.asarray(ys), xn, yn, gather=True,
                                    impl="scan", **kw)
        return o.sum(), o
    (_, out), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(lp).astype(jdtype))
    return np.asarray(out, np.float32), np.asarray(grad.astype(jnp.float32))


@pytest.mark.parametrize("variant", sorted(cc.VARIANTS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_compiled_step_equals_direct_call_and_jax(layout, dtype, variant):
    kw = cc.VARIANTS[variant]
    lp, ys, xn, yn = _inputs(layout, dtype)
    tdtype, jdtype = DTYPES[dtype]
    x = torch.tensor(lp).to(tdtype)
    labels, lengths = tt(ys), tt(xn, yn)
    step = cs.compiled_step(cc.loss_grad(labels, *lengths, **kw),
                            key=("test", variant), donate_argnums=(0,))
    loss, grad = step(x)

    direct = x.detach().clone().requires_grad_()
    out = wt.rnnt_loss(direct, labels, *lengths, gather=True, **kw)
    out.sum().backward()
    assert torch.equal(loss, out.detach()) and torch.equal(grad, direct.grad)
    assert grad.dtype == tdtype and grad.shape == x.shape

    jout, jgrad = _jax_loss_grad(lp, ys, xn, yn, jdtype, kw)
    np.testing.assert_allclose(loss.numpy(), jout, **COST_TOL)
    g = grad.float().numpy()
    np.testing.assert_allclose(g, jgrad, rtol=0,
                               atol=GRAD_SHARE * np.abs(jgrad).max())


@pytest.mark.parametrize("offset", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flat_grad_write_into_out(dtype, offset):
    rng = np.random.RandomState(3)
    N, T, U, V = 2, 5, 4, 9
    ct0, ct1 = tt(rng.randn(N, T, U).astype(np.float32),
                  rng.randn(N, T, U).astype(np.float32))
    loc = tt(rng.randint(0, V + (offset or 0), (N, U)).astype(np.int32))
    args = (ct0, ct1, loc, (offset or 0) + 1, V, U * V)
    want = flat_kernels.flat_grad_write(*args, out_dtype=dtype, offset=offset)
    for write in (flat_kernels.flat_grad_write,
                  flat_kernels.flat_grad_write_plain):
        out = torch.full((N, T, U * V), float("nan"), dtype=dtype)
        got = write(*args, out_dtype=dtype, offset=offset, out=out)
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_flat_grad_write_refuses_a_wrong_out(bad):
    N, T, U, V = 2, 3, 2, 5
    ct = torch.zeros(N, T, U)
    loc = torch.zeros(N, U, dtype=torch.int32)
    out = {"shape": torch.empty(N, T, U * V + 1),
           "dtype": torch.empty(N, T, U * V, dtype=torch.float64),
           "strided": torch.empty(N, U * V, T).transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match="out must be a contiguous"):
        flat_kernels.flat_grad_write(ct, ct, loc, 0, V, U * V, out=out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["4d", "flat"])
def test_donated_route_writes_into_the_log_probs(layout, dtype):
    lp, ys, xn, yn = _inputs(layout, dtype, seed=21)
    x = torch.tensor(lp).to(DTYPES[dtype][0])
    fn = cc.loss_grad(*tt(ys, xn, yn), reduction="mean")
    want_loss, want_grad = fn(x)
    assert want_grad.data_ptr() != x.data_ptr()  # eager: a new buffer

    donated = x.clone()
    with cs._tracing([donated]):
        loss, grad = fn(donated)
    assert grad.data_ptr() == donated.data_ptr() and grad.shape == x.shape
    assert torch.equal(loss, want_loss) and torch.equal(grad, want_grad)
    assert torch.equal(donated, want_grad)  # the log-probs are gone


def test_a_donation_mark_is_taken_once():
    x = torch.zeros(2, 3, 4, 5)
    assert not cs.take_donated(x)  # outside a trace
    with cs._tracing([x]):
        assert not cs.take_donated(x[:1])  # not the whole buffer
        assert not cs.take_donated(x.transpose(1, 2))
        assert cs.take_donated(x.view(2, 3, 20))
        assert not cs.take_donated(x)
    assert not cs.tracing()


def test_two_gathers_of_one_donated_buffer():
    """Only the first gather of a donated buffer writes into it, so two
    losses on one argument still sum two separate gradients."""
    xs, ys, xn, yn = loss_inputs(22)
    x = torch.tensor(xs)
    args = tt(ys, xn, yn)

    def two(z):
        z = z.detach().requires_grad_()
        loss = (wt.rnnt_loss(z, *args, reduction="sum")
                + 2 * wt.rnnt_loss(z, *args, reduction="sum"))
        return loss.detach(), torch.autograd.grad(loss, z)[0]

    want = two(x)
    donated = x.clone()
    with cs._tracing([donated]):
        got = two(donated)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cache_key_separates_what_changes_the_graph(monkeypatch):
    step = cs.compiled_step(lambda x: (x,), key="a")
    x = torch.zeros(2, 3)
    base = step._cache_key((x,))
    assert step._cache_key((torch.ones(2, 3),)) == base
    others = [
        step._cache_key((torch.zeros(3, 2),)),
        step._cache_key((torch.zeros(2, 3, dtype=torch.float64),)),
        step._cache_key((torch.zeros(2, 3, requires_grad=True),)),
        cs.compiled_step(lambda x: (x,), key="b")._cache_key((x,)),
        cs.compiled_step(lambda x: (x,), key="a",
                         donate_argnums=(0,))._cache_key((x,)),
    ]
    with torch.no_grad():
        others.append(step._cache_key((x,)))
    with torch.inference_mode():
        others.append(step._cache_key((x,)))
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_tf32", not matmul.allow_tf32)
    others.append(step._cache_key((x,)))
    monkeypatch.undo()
    monkeypatch.setenv("WARP_RNNT_DEBUG", "1")
    others.append(step._cache_key((x,)))
    assert len(set(others)) == len(others) and base not in others


def test_canary_check_deferred_while_traced(monkeypatch):
    """The chosen behaviour: while traced, the canary reads nothing and
    registers a check; the check warns as an eager call does."""
    monkeypatch.setenv("WARP_RNNT_DEBUG", "1")
    xs, ys, xn, yn = bl.make_batch(0, 3, 20, 5, 12, device="cpu")
    monkeypatch.setattr(cc.cuda_impl, "alpha_beta",
                        cc._perturbed(cc.cuda_impl.alpha_beta))
    fn = cc.loss_grad(ys, xn, yn, reduction="sum", impl="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with cs._tracing() as trace:
            fn(xs)
    assert len(trace.checks) == 1
    with pytest.warns(RuntimeWarning, match=r"mismatch.*mask=\[False, True"):
        trace.checks[0]()
    monkeypatch.setenv("WARP_RNNT_DEBUG", "0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trace.checks[0]()
        with cs._tracing() as trace:
            fn(xs)
    assert not trace.checks


def test_canary_warns_on_every_eager_call():
    assert cc.check_canary(device="cpu") == 2


def test_after_replay_needs_a_trace():
    with pytest.raises(RuntimeError, match="outside a compiled step"):
        cs.after_replay(lambda: None)


@pytest.mark.parametrize("case", ["no key", "not a tuple", "not a tensor",
                                  "donated index"])
def test_compiled_step_validation(case):
    x = torch.zeros(2)
    if case == "no key":
        with pytest.raises(ValueError, match="needs a key"):
            cs.compiled_step(lambda x: (x,), key=None)
        return
    fn = (lambda x: x) if case == "not a tuple" else (lambda x: (x,))
    step = cs.compiled_step(fn, key=case,
                            donate_argnums=(1,) if case == "donated index"
                            else ())
    exc = ValueError if case == "donated index" else TypeError
    with pytest.raises(exc):
        step(1.0) if case == "not a tensor" else step(x)


def test_compiled_step_is_not_exported():
    import warp_rnnt_tpu_torch.utils as utils

    assert "compiled_step" not in utils.__all__
    assert "compiled_step" not in wt.__all__


@pytest.mark.parametrize("flat", [False, True])
def test_bench_loss_compiled_calls_equal_eager_on_cpu(flat):
    xs, ys, xn, yn = bl.make_batch(1, 2, 6, 3, 7, flat=flat, device="cpu")
    step = bl.loss_grad_step(ys, xn, yn)
    assert isinstance(step, cs.CompiledStep)
    got = step(xs)
    want = bl.loss_grad_step(ys, xn, yn, compiled=False)(xs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(bl.costs_fn(ys, xn, yn)(xs),
                       bl.costs_fn(ys, xn, yn, compiled=False)(xs))


@pytest.mark.parametrize("call", ["scalar_chain", "host_path"])
def test_compiled_timers_need_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.zeros(3)
    with pytest.raises((RuntimeError, SystemExit), match="CUDA device"):
        if call == "scalar_chain":
            timing.bench_scalar_chain(torch.sum, (x,), 2, key="k")
        else:
            host_path.breakdown(1, 4, 2, 5)
