"""The compiled loss+grad's checks on a CUDA device, in one place:
`chip_smoke.py` (`phase_compiled_main`) runs them at the main path's and
the README table's widths and `tests/test_torch_compiled_card.py` at small
ones.  Each check raises an AssertionError on a failure.

  * `check_row`: at one shape (`bench_loss.make_batch`'s inputs, 4-D or
    flat, fp32 or bf16) and for each of ``variants`` (`VARIANTS`: the
    three reductions, ``average_frames``, FastEmit 0.3), the loss+grad
    compiled with its log-probs donated (`utils.compiled_step`) equals the
    same function called eagerly bit for bit (``torch.equal``) on loss and
    gradient, its gradient in the log-probs' static buffer; so do the
    no-grad costs.  Then new log-probs drawn from another seed are copied
    into the static buffers and the graph replayed: again equal to eager
    on those same values, so a stale graph cannot pass.  A chain of
    `CHAIN` donated calls copies no argument and leaves
    ``torch.cuda.memory_allocated()`` where it was.  It reads the chained
    ms eager and compiled, the capture ms and the graph's pool MiB, and
    with ``profile`` a replay's kernels against an eager call's.
  * `check_canary`: with ``WARP_RNNT_DEBUG=1`` a compiled call whose
    canary trips (sample 1's beta[0, 0] scaled after the sweep) warns
    after its replay, every call, as an eager call does; without it, no
    warning.

The eager side is the very function the step compiles, so the two run
the same kernels on the same values; only the gradient's buffer differs.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from unittest import mock

import torch

from warp_rnnt_tpu_torch import rnnt_loss
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.ops import cuda_impl
from warp_rnnt_tpu_torch.utils import compiled_step as cs

VARIANTS = {
    "mean": dict(reduction="mean"),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "average_frames": dict(reduction="mean", average_frames=True),
    "fastemit": dict(reduction="mean", fastemit_lambda=0.3),
}
CHAIN = 50


def loss_grad(ys, xn, yn, **kw):
    """x -> (loss, d sum(loss) / d x) of `rnnt_loss(x, ..., gather=True,
    **kw)`: the call a compiled step captures."""
    def fn(x):
        x = x.detach().requires_grad_()
        loss = rnnt_loss(x, ys, xn, yn, gather=True, **kw)
        (grad,) = torch.autograd.grad(loss.sum() if loss.dim() else loss, x)
        return loss.detach(), grad
    return fn


def costs(ys, xn, yn):
    """x -> (the (N,) costs,) without autograd."""
    def fn(x):
        with torch.no_grad():
            return (rnnt_loss(x, ys, xn, yn, gather=True),)
    return fn


def _names(ys, xn, yn):
    return (ys.data_ptr(), xn.data_ptr(), yn.data_ptr())


def _equal(what, got, want, names=("loss", "grad")):
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            err = (g.double() - w.double()).abs().max().item()
            raise AssertionError(f"{what}: compiled {name} differs from eager"
                                 f" (max abs err {err})")


def check_row(N, T, L, V, dtype=torch.float32, flat=False, variants=("mean",),
              iters=None, profile=False, seed=0):
    """The checks of the module docstring at (N, T, L labels, V).  Returns
    {"eager_ms", "compiled_ms" (chained, with ``iters``), "capture_ms",
    "pool_mib", "copies" (input copies in the chain), "memory_growth"
    (bytes), "kernels" ({"eager": {kernel: a call}, "compiled": ...})
    with ``profile``}."""
    xs, ys, xn, yn = bl.make_batch(seed, N, T, L, V, dtype, flat=flat)
    new = bl.make_batch(seed + 1, N, T, L, V, dtype, flat=flat)[0]
    tag = (f"compiled N={N} T={T} L={L} V={V} {str(dtype)[6:]}"
           f"{' flat' * flat}")
    out = {}
    for name in variants:
        fn = loss_grad(ys, xn, yn, **VARIANTS[name])
        step = cs.compiled_step(fn, key=("compiled_cases", name,
                                         *_names(ys, xn, yn)),
                                donate_argnums=(0,))
        try:
            got = step(xs)
            if got[1].data_ptr() != step.entry.args[0].data_ptr():
                raise AssertionError(f"{tag} {name}: the gradient is not in"
                                     " the donated log-probs' buffer")
            _equal(f"{tag} {name}", got, fn(xs))
            step.entry.args[0].copy_(new)
            _equal(f"{tag} {name}, new log-probs", step.entry.replay(),
                   fn(new))
            if name == variants[0]:
                out.update(_chain(step, xs, tag))
                out["capture_ms"] = step.entry.capture_ms
                out["pool_mib"] = step.entry.pool_bytes / 2**20
                if profile:
                    out["kernels"] = _kernels(fn, step, xs)
                if iters:
                    out.update(_chained_ms(ys, xn, yn, step, xs, iters))
        finally:
            step.release()
    fn = costs(ys, xn, yn)
    step = cs.compiled_step(fn, key=("compiled_cases", "costs",
                                     *_names(ys, xn, yn)))
    try:
        _equal(f"{tag} no-grad", step(xs), fn(xs), ("costs",))
        step.entry.args[0].copy_(new)
        _equal(f"{tag} no-grad, new log-probs", step.entry.replay(), fn(new),
               ("costs",))
    finally:
        step.release()
    return out


def _chain(step, xs, tag):
    """`CHAIN` donated calls, each on the last one's gradient."""
    x = step(xs)[1]
    torch.cuda.synchronize()
    copies, before = cs.STATS["input_copies"], torch.cuda.memory_allocated()
    for _ in range(CHAIN):
        x = step(x)[1]
    torch.cuda.synchronize()
    r = {"copies": cs.STATS["input_copies"] - copies,
         "memory_growth": torch.cuda.memory_allocated() - before}
    if r["copies"] or r["memory_growth"] > 0:
        raise AssertionError(f"{tag}: a donated chain of {CHAIN} calls made"
                             f" {r['copies']} input copies and grew"
                             f" {r['memory_growth']} bytes")
    if not torch.isfinite(x).all():
        raise AssertionError(f"{tag}: the chain's gradient is not finite")
    return r


def _chained_ms(ys, xn, yn, step, xs, iters):
    """Chained ms of the eager loss+grad (`bench_loss.loss_grad_step`) and
    of the compiled step, one after the other."""
    eager = bl.loss_grad_step(ys, xn, yn, compiled=False)
    return {"eager_ms": timing.bench_grad_chain(eager, xs, iters),
            "compiled_ms": timing.bench_grad_chain(step, xs, iters)}


def _kernels(fn, step, xs):
    """{kernel: launches a call} of eager calls and of replays, under the
    profiler; they must be the same set."""
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile

    state = {"x": xs}

    def replay():
        state["x"] = step(state["x"])[1]

    got = {}
    for side, call in (("eager", lambda: fn(xs)), ("compiled", replay)):
        call()  # the replays' first call copies xs into the static buffer
        torch.cuda.synchronize()
        r = device_profile(call, 10)
        if not r["complete"]:
            raise AssertionError(f"profile of the {side} calls incomplete")
        got[side] = {key: n for _, n, key in r["rows"]}
    if got["eager"] != got["compiled"]:
        raise AssertionError(f"a replay's kernels {got['compiled']} differ"
                             f" from an eager call's {got['eager']}")
    return got


@contextlib.contextmanager
def _debug(on):
    saved = os.environ.get("WARP_RNNT_DEBUG")
    os.environ["WARP_RNNT_DEBUG"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["WARP_RNNT_DEBUG"]
        else:
            os.environ["WARP_RNNT_DEBUG"] = saved


def _perturbed(real):
    def alpha_beta(*a, **k):
        alphas, betas = real(*a, **k)
        betas[1, 0, 0] *= 1.01  # ll_b off by 1 %: the canary trips
        return alphas, betas
    return alpha_beta


def check_canary(device="cuda", N=3, T=20, L=5, V=12, seed=0):
    """`check_canary` of the module docstring; returns the warnings' count
    with the variable set (one a call, two calls)."""
    xs, ys, xn, yn = bl.make_batch(seed, N, T, L, V, device=device)
    with mock.patch.object(cuda_impl, "alpha_beta",
                           _perturbed(cuda_impl.alpha_beta)):
        fn = loss_grad(ys, xn, yn, reduction="sum", impl="cuda")
        step = cs.compiled_step(fn, key=("compiled_cases.canary",
                                         *_names(ys, xn, yn)),
                                donate_argnums=(0,))
        try:
            with _debug(True), warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                for _ in range(2):
                    step(xs)
            tripped = [x for x in w if "mismatch" in str(x.message)
                       and "mask=[False, True" in str(x.message)]
            if len(tripped) != 2:
                raise AssertionError(f"with WARP_RNNT_DEBUG=1 two compiled"
                                     f" calls warned {len(tripped)} times")
            with _debug(False), warnings.catch_warnings():
                warnings.simplefilter("error")
                step(xs)
        finally:
            step.release()
    return len(tripped)
