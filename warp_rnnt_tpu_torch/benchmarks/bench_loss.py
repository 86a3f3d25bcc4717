"""The loss benchmark on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_loss.py`), and `bench.py`'s headline.

    python -m warp_rnnt_tpu_torch.benchmarks.bench_loss [--headline]

`CONFIGS` are the JAX module's, warp-rnnt's README table configurations:
(T, labels, V, iters).  `run_loss_bench` times `rnnt_loss(...,
reduction="mean", gather=True)` plus backward on random log-softmax
inputs, each call's gradient fed in as the next call's input
(`timing.bench_grad_chain`), or the no-grad costs summed into a scalar
(`timing.bench_scalar_chain`); both report the two-point marginal ms per
call on CUDA events.  `headline()` is `bench.py`'s measurement on the port
(N=32, T=150, 20 labels, V=5000, full lengths; 50 iterations, 3 warm-up
calls, best of 3), with its keys and its baseline, warp-rnnt's 12.35 ms
on an RTX 2070 Super; `bench.py` itself times the JAX package.

The CLI prints one line a (config, N) over N in {1, 16, 32, 64, 128};
with ``--headline`` the headline's JSON line only.  It needs a CUDA
device and turns TF32 off, as the other CLIs of the port do.

Not ported: `use_flat_layout` and `flat_layout_cliff`, which answer where
XLA's 4-D gather leaves its fast path on the TPU (the CUDA gather has no
such cliff); the 4-D layout is the default and ``flat=True`` asks for the
(N, T, (U+1)*V) one.  Nor the ``donate`` flag: torch has no donation, so
a chain holds the input, the current gradient and the next one.
"""

from __future__ import annotations

import json
import math
import sys

import torch

from warp_rnnt_tpu_torch import rnnt_loss
from warp_rnnt_tpu_torch.benchmarks import timing

CONFIGS = [
    # (T, U_labels, V, iters)
    (150, 40, 28, 100),
    (150, 20, 5000, 50),
    (1500, 300, 50, 10),
]
BATCHES = (1, 16, 32, 64, 128)
# Above this many bytes of log-probs `make_batch` draws the one-buffer
# surrogate instead of log_softmax(randn), which holds two.
SURROGATE_BYTES = 6 << 30
# bench.py's config and baseline: warp-rnnt's gather=True at N=32, T=150,
# 20 labels, V=5000 on an RTX 2070 Super (its README.md:46).
HEADLINE = dict(N=32, T=150, U=20, V=5000)
BASELINE_MS = 12.35
METRIC = "rnnt_loss+grad ms/batch (N=32,T=150,U=20,V=5000, gather)"


def _require_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("bench_loss needs a CUDA device")


def uses_surrogate(N, T, U, V, dtype=torch.float32) -> bool:
    """True where `make_batch` draws the surrogate: the (N, T, U+1, V)
    log-probs take more than `SURROGATE_BYTES`."""
    return torch.finfo(dtype).bits // 8 * N * T * (U + 1) * V > SURROGATE_BYTES


def make_batch(seed, N, T, U, V, dtype=torch.float32, flat=False,
               device="cuda"):
    """Random benchmark inputs (log_probs, labels, xn, yn) on ``device``,
    drawn from one `torch.Generator` seeded with ``seed``.

    log_probs is log_softmax(randn) over V, (N, T, U+1, V), or with
    ``flat=True`` the same values as (N, T, (U+1)*V).  Above
    `SURROGATE_BYTES` the log_softmax would hold two full buffers, so there
    it is the one-buffer surrogate randn * 0.5 - log(V), as in the JAX
    module: the kernels' work does not depend on the values.  labels
    (N, U) in [1, V), xn = T, yn in [U//2 + 1, U]; int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (N, T, (U + 1) * V) if flat else (N, T, U + 1, V)
    if uses_surrogate(N, T, U, V, dtype):
        xs = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        xs.mul_(0.5).sub_(math.log(V))
    else:
        xs = torch.log_softmax(
            torch.randn(N, T, U + 1, V, generator=gen, dtype=dtype,
                        device=device), dim=-1).reshape(shape)
    i32 = dict(dtype=torch.int32, device=device)
    ys = torch.randint(1, V, (N, U), generator=gen, **i32)
    xn = torch.full((N,), T, **i32)
    yn = torch.randint(U // 2 + 1, U + 1, (N,), generator=gen, **i32)
    return xs, ys, xn, yn


def loss_grad_step(ys, xn, yn, impl="auto"):
    """x -> (mean loss, d loss / d x): the timed call of the loss+grad
    chain."""
    def step(x):
        x = x.detach().requires_grad_()
        loss = rnnt_loss(x, ys, xn, yn, reduction="mean", gather=True,
                         impl=impl)
        loss.backward()
        return loss.detach(), x.grad
    return step


def costs_fn(ys, xn, yn, impl="auto"):
    """x -> the (N,) costs, without autograd: the timed no-grad call."""
    def costs(x):
        with torch.no_grad():
            return rnnt_loss(x, ys, xn, yn, reduction="none", gather=True,
                             impl=impl)
    return costs


def run_loss_bench(N, T, U, V, iters, grad=True, impl="auto",
                   dtype=torch.float32, flat=False, seed=0):
    """Marginal ms per loss+grad call (``grad=True``; each gradient is the
    next call's input) or per no-grad call (a scalar accumulator sums every
    call's costs), at one config on the card."""
    _require_cuda()
    xs, ys, xn, yn = make_batch(seed, N, T, U, V, dtype, flat=flat)
    if grad:
        return timing.bench_grad_chain(loss_grad_step(ys, xn, yn, impl), xs,
                                       iters)
    return timing.bench_scalar_chain(costs_fn(ys, xn, yn, impl), (xs,), iters,
                                     reduce_out=torch.sum)


def profile_row(N, T, U, V, seed=0):
    """One table row's loss+grad and no-grad calls under the profiler
    (`profile_loss.profile_step`): {"loss_grad": ..., "no_grad": ...},
    each with the step's ms without the profiler, kernels a call, busy ms,
    idle share and the device ms of each kernel a call."""
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step

    _require_cuda()
    xs, ys, xn, yn = make_batch(seed, N, T, U, V)
    step, costs = loss_grad_step(ys, xn, yn), costs_fn(ys, xn, yn)
    return {"loss_grad": profile_step(lambda: step(xs)),
            "no_grad": profile_step(lambda: costs(xs))}


def headline(seed=0):
    """`bench.py`'s measurement on the port: best of 3 two-point marginals
    of 50 chained loss+grad calls after 3 warm-up calls, at `HEADLINE`
    with full label lengths.  Returns bench.py's keys ("metric", "value"
    in ms, "unit", "vs_baseline" against `BASELINE_MS`) and the card's
    "device" and "power_limit"."""
    from warp_rnnt_tpu_torch.utils.profiling import card

    _require_cuda()
    N, T, U, V = (HEADLINE[k] for k in "NTUV")
    xs, ys, xn, _ = make_batch(seed, N, T, U, V)
    yn = torch.full((N,), U, dtype=torch.int32, device=xs.device)
    best = timing.bench_grad_chain(loss_grad_step(ys, xn, yn), xs, iters=50,
                                   warmup=3, repeats=3)
    return {"metric": METRIC, "value": round(best, 3), "unit": "ms",
            "vs_baseline": round(BASELINE_MS / best, 3), **card()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--headline" in argv:
        print(json.dumps(headline()), flush=True)
        return
    from warp_rnnt_tpu_torch.utils.profiling import card_line

    print(f"device: {card_line()} (torch {torch.__version__})", flush=True)
    for T, U, V, iters in CONFIGS:
        for N in BATCHES:
            try:
                ms = run_loss_bench(N, T, U, V, iters)
                print(f"T={T} U={U} V={V} N={N}: {ms:8.3f} ms/batch"
                      " (loss+grad)", flush=True)
            except torch.cuda.OutOfMemoryError:
                print(f"T={T} U={U} V={V} N={N}: failed: OutOfMemoryError",
                      flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
