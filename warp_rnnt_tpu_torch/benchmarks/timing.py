"""Dependency-forced chain timing on CUDA events (counterpart of
`warp_rnnt_tpu/benchmarks/timing.py`).

Two rules make a per-call device time trustworthy:

  * CHAINING: every timed iteration consumes the previous one's output --
    the next input is the previous gradient (`bench_grad_chain`), or a
    scalar accumulator threads through every call (`bench_scalar_chain`) --
    so the timed window is the serialized cost of the calls, each of which
    must finish its work for the next to be correct.
  * TWO-POINT calibration: a chain is timed at two iteration counts and the
    marginal cost

        ms/iter = (T(iters_hi) - T(iters_lo)) / (iters_hi - iters_lo)

    is reported, which cancels the fixed cost of starting and stopping a
    timed window (the first launch's host latency, the event records).

Compiled steps (`utils.compiled_step`, the port's ``jax.jit``) chain as
JAX's jitted ones do: `bench_grad_chain` takes a donated step as it is
(its gradient comes back in the input's static buffer, so the next call
copies nothing), and `bench_scalar_chain` with a ``key`` compiles ``fn``
and the reduction into one step whose accumulator is donated
(`make_scalar_chain`) and, after the warm-up, passes that step its own
static arguments, so no call copies its inputs either.

Times come from `torch.cuda.Event`s recorded on the current stream around
the chain, read after `synchronize()`.  A call whose device work is shorter
than its host launch path reads the host in a chain; `bench_graph` times
such calls on the device alone, replaying them from a CUDA graph, and
`bench_host` the host alone, enqueueing them behind a device-side sleep.
There is no CPU route: without a CUDA device these functions raise.
"""

from __future__ import annotations

import torch

from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

_MIN_SIGNAL_MS = 20.0

# (HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 tensor-core
# FLOP/s) by a word of the card's name, NVIDIA data sheets; the H100 SXM
# where no word matches.  Every bound the benchmarks print divides by these.
CARD_RATES = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
              "H200": (4.8e12, 67e12, 989e12)}
_RATES_SXM = (3.35e12, 67e12, 989e12)


def card_rates(name=None):
    """The rates tuple of the card named ``name`` (default: CUDA device 0)."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    return _RATES_SXM


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("chain timing needs a CUDA device")


def _elapsed_ms(run_k, k) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_k(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _two_point(run, iters, repeats):
    """run(k) enqueues k chained iterations; returns the best marginal
    ms/iter over `repeats` (lo, hi) pairs.  The iteration count grows until
    T_hi - T_lo exceeds _MIN_SIGNAL_MS, so sub-ms calls are not lost in the
    fixed cost."""
    k = max(iters, 4)
    for _ in range(8):  # growth attempts
        lo = max(2, k // 4)
        hi = lo + k
        t_lo = _elapsed_ms(run, lo)
        t_hi = _elapsed_ms(run, hi)
        if t_hi - t_lo > _MIN_SIGNAL_MS or k >= 4096:
            break
        k *= 4
    best = (t_hi - t_lo) / (hi - lo)
    for _ in range(repeats - 1):
        t_lo = _elapsed_ms(run, lo)
        t_hi = _elapsed_ms(run, hi)
        best = min(best, (t_hi - t_lo) / (hi - lo))
    return max(best, 0.0)


def bench_grad_chain(step, x0, iters, warmup=3, repeats=2):
    """step: x -> (aux, x_like), e.g. loss and gradient, eager or a
    compiled step with x donated.  Each iteration's x_like is the next
    iteration's x.  Returns the marginal ms/call."""
    _require_cuda()
    state = {"x": x0}
    for _ in range(warmup):
        _, state["x"] = step(state["x"])
    torch.cuda.synchronize()

    def run(k):
        x = state["x"]
        for _ in range(k):
            _, x = step(x)
        state["x"] = x

    return _two_point(run, iters, repeats)


def _sum_outputs(out):
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return sum(leaf.float().sum() for leaf in leaves if leaf is not None)


def make_scalar_chain(fn, key, reduce_out=None):
    """JAX's `make_scalar_chain` on the port: a compiled step (acc, *args)
    -> (acc + reduce_out(fn(*args)),) with the accumulator donated, cached
    under ``key``, which must name ``fn`` and ``reduce_out`` (see
    `utils.compiled_step`)."""
    reduce_out = reduce_out or _sum_outputs
    return compiled_step(lambda acc, *args: (acc + reduce_out(fn(*args)),),
                         key=("timing.make_scalar_chain", key),
                         donate_argnums=(0,))


def bench_scalar_chain(fn, args, iters, warmup=3, repeats=2, reduce_out=None,
                       key=None):
    """Marginal ms/call of `fn(*args)`, each call's output folded into a
    scalar accumulator that the next iteration carries.

    The default reduction sums every output tensor, which adds one read of
    the outputs to the time; pass a cheaper `reduce_out` (say, one element)
    for a kernel whose outputs are large.  With a ``key`` the call and the
    reduction run as one compiled step (`make_scalar_chain`), fed its own
    static arguments after the warm-up; its graphs are dropped before this
    returns.  Without one they run eagerly."""
    _require_cuda()
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    state = {"acc": torch.zeros((), dtype=torch.float32, device=device)}
    if key is not None:
        step = make_scalar_chain(fn, key, reduce_out)
        try:
            for _ in range(max(warmup, 1)):  # the first call captures
                state["acc"] = step(state["acc"], *args)[0]
            args = step.entry.args[1:]
            torch.cuda.synchronize()

            def run(k):
                acc = state["acc"]
                for _ in range(k):
                    acc = step(acc, *args)[0]
                state["acc"] = acc

            return _two_point(run, iters, repeats)
        finally:
            step.release()

    reduce_out = reduce_out or _sum_outputs
    for _ in range(warmup):
        state["acc"] = state["acc"] + reduce_out(fn(*args))
    torch.cuda.synchronize()

    def run(k):
        acc = state["acc"]
        for _ in range(k):
            acc = acc + reduce_out(fn(*args))
        state["acc"] = acc

    return _two_point(run, iters, repeats)


def bench_graph(fn, args, calls=32, flush_bytes=96 << 20):
    """Device ms per call of `fn(*args)` with the host's launch cost taken
    out, for calls whose work is shorter than their launch path (a chained
    time then reads the host).  `calls` calls are captured in one CUDA graph
    and replayed, timed with CUDA events, best of three replays.

    Before each call a write of `flush_bytes` (default 96 MiB, more than the
    50 MB L2 cache) evicts what the last call read, so the call finds its
    inputs in device memory, as a caller that has just written other data
    does; the writes' own time, from a graph of writes alone, is
    subtracted.  Outputs are dropped."""
    _require_cuda()
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    flush = torch.empty(max(flush_bytes // 4, 1), dtype=torch.float32,
                        device=device)
    fn(*args)  # warm up outside the capture (builds, lazy inits)
    torch.cuda.synchronize()

    def graph_ms(with_call):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                if flush_bytes:
                    flush.fill_(1.0)
                if with_call:
                    fn(*args)
        g.replay()
        torch.cuda.synchronize()
        return min(_elapsed_ms(lambda _: g.replay(), 1)
                   for _ in range(3)) / calls

    flush_ms = graph_ms(False) if flush_bytes else 0.0
    return max(graph_ms(True) - flush_ms, 0.0)


def bench_host(fn, args, calls=200, repeats=5, sleep_cycles=200_000_000):
    """Host microseconds per call of `fn(*args)`: the host's own cost of
    issuing it, apart from the device's.  A device-side sleep of
    `sleep_cycles` (about 0.1 s) is enqueued first, so the calls queue
    behind it and none waits for the device; `calls` calls are timed on the
    host clock, best of `repeats`, and the queue is drained after each.
    Keep `calls` times the call's launches well under the device's launch
    queue (about a thousand): past it the host blocks until the sleep
    ends, and the reading is the sleep's, not the host's."""
    import time

    _require_cuda()
    fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best
