"""A step compiled once per shape: the port's counterpart of ``jax.jit``
with ``donate_argnums`` (no JAX file; in the JAX package XLA compiles
every benchmarked call, `warp_rnnt_tpu/benchmarks/bench_loss.py`).

`compiled_step(fn, key=..., donate_argnums=(...))` returns a callable
``step(*tensors) -> tuple of tensors`` that computes ``fn(*tensors)``.
``fn`` takes tensors and returns a tuple of tensors; it may run autograd
inside (``backward``, ``torch.autograd.grad``), so one step can be a whole
loss and gradient.

  * On the CPU (the tests, and any caller that asks for the CPU) ``fn``
    runs eagerly: this is the plain version.
  * On a CUDA device the first call of a shape makes static copies of the
    arguments, runs ``fn`` on them once on a side stream (the warm-up:
    the kernels' build and load, cuBLAS's workspace, the autograd
    engine's threads), then captures ``fn`` into one `torch.cuda.CUDAGraph`;
    every call replays that graph.  An argument whose ``data_ptr`` and
    strides are the static buffer's is not copied; any other is copied
    into the static buffer before the replay (`STATS["input_copies"]`
    counts those copies).  A failure to capture or replay raises: nothing
    on a CUDA tensor falls back to eager, which runs on the card only
    inside `_plain()` (the plain version the graphs are held against).

The outputs on a CUDA device are the graph's static tensors: they hold the
last call's values and are overwritten by the next call of the same entry,
as `torch.cuda.graph`'s outputs are.  Clone what must outlive it.

Donation.  For each index in ``donate_argnums`` the first output of the
argument's shape and dtype comes back in that argument's static buffer,
as XLA reuses a donated buffer: where ``fn`` wrote it there itself (the
gather's backward writes the gradient into the log-probs it read, see
`take_donated`) nothing moves; otherwise the graph ends with a copy into
the buffer.  So a chain ``x = step(x)[1]`` copies nothing and allocates
no tensor a call, and an accumulator ``acc = step(acc, x)[0]`` likewise.
The caller's own tensors are never written: the first call copies them.

Graphs are cached, least recently used first out past `CACHE_SIZE`, by
the caller's ``key`` (required; it must name what ``fn`` closes over: a
cached entry replays the ``fn`` of its first capture.  A tensor ``fn``
closes over may be named by its ``data_ptr``: the entry keeps ``fn``, and
so the tensor, alive, and no other tensor can take that address while the
entry is cached), the donated indices, the shapes, dtypes and
``requires_grad`` of the arguments, the device, grad and inference mode,
the TF32 and reduced-precision flags of cuBLAS and cuDNN, and whether the
loss's debug canary is on (``WARP_RNNT_DEBUG``).

What a capture does not do again on a replay: Python.  Launch counters
(each wrapper's ``LAUNCHES``) count the warm-up's and the capture's
launches and nothing at a replay; hold a path's launches on eager calls.
A host read inside ``fn`` cannot be captured (the compact layout reads
its lengths on the host: capturing it raises).  A check that must read
the host registers itself with `after_replay` while the step is traced
and runs after each replay: the loss's canary (``WARP_RNNT_DEBUG``) warns
after the replay of a call that trips it, as an eager call does.

Not thread-safe: one thread at a time captures and replays.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from warp_rnnt_tpu_torch.utils.device_loop import _flags

CACHE_SIZE = 32  # graphs kept
STATS = {"captures": 0, "replays": 0, "input_copies": 0}

_CACHE = collections.OrderedDict()
_EAGER_ON_CARD = False  # set only inside `_plain()`
_SIDE = {}  # one capture stream a device (cuBLAS keeps a workspace a stream)
_TRACE = None  # the `_Trace` of the warm-up or capture under way


class _Trace:
    """What a warm-up or capture of ``fn`` records: the donated buffers
    not yet taken, as (data_ptr, bytes), and the host checks to run after
    each replay."""

    def __init__(self, donated):
        self.donated = [(x.data_ptr(), x.numel() * x.element_size())
                        for x in donated]
        self.checks = []


@contextlib.contextmanager
def _tracing(donated=()):
    """Within the block ``fn`` is traced: the tensors ``donated`` may be
    taken by `take_donated`, and `after_replay` records checks.  The
    warm-up and the capture each run in one; the tests run the donated
    route and the deferred checks on the CPU in one."""
    global _TRACE
    saved, _TRACE = _TRACE, _Trace(donated)
    try:
        yield _TRACE
    finally:
        _TRACE = saved


def tracing() -> bool:
    """True while a compiled step warms up or captures its ``fn``."""
    return _TRACE is not None


def take_donated(x) -> bool:
    """True, once, where ``x`` spans the whole buffer of an argument that
    the step being traced donates (the buffer itself or a contiguous view
    of all of it): its caller may then write its gradient into ``x``.
    False outside a trace."""
    if _TRACE is None or not x.is_contiguous():
        return False
    span = (x.data_ptr(), x.numel() * x.element_size())
    if span not in _TRACE.donated:
        return False
    _TRACE.donated.remove(span)
    return True


def after_replay(check):
    """Run the host callable ``check`` after each replay of the graph being
    captured (a warm-up's checks are dropped).  For a check that reads
    the host, which a capture cannot hold: ``check`` reads tensors the
    graph writes."""
    if _TRACE is None:
        raise RuntimeError("after_replay outside a compiled step's trace")
    _TRACE.checks.append(check)


class _Entry:
    """One captured step: its graph, its static arguments and outputs, the
    checks to run after a replay, and what it cost to make (host ms of the
    warm-up and capture; bytes the graph's private pool reserved)."""

    def __init__(self, key, graph, args, outputs, checks, fn, capture_ms,
                 pool_bytes):
        self.key, self.graph = key, graph
        self.args, self.outputs, self.checks = args, outputs, checks
        self.fn = fn  # kept alive: what the key names stays at its address
        self.capture_ms, self.pool_bytes = capture_ms, pool_bytes

    def replay(self):
        """Replay the graph on the static arguments as they stand, then run
        the deferred checks; returns the static outputs."""
        self.graph.replay()
        STATS["replays"] += 1
        for check in self.checks:
            check()
        return self.outputs


def _outputs(out):
    if not isinstance(out, (tuple, list)) or not all(
            isinstance(o, torch.Tensor) for o in out):
        raise TypeError("a compiled step's fn must return a tuple of tensors,"
                        f" got {type(out).__name__}")
    return tuple(out)


def _static(x):
    return x.detach().clone(memory_format=torch.contiguous_format
                            ).requires_grad_(x.requires_grad)


def _same_buffer(a, b):
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


def _donate(outs, args, donate):
    """Each donated argument's buffer takes the first unclaimed output of
    its shape and dtype: copied there at the end of the capture unless
    ``fn`` wrote it there already."""
    outs, taken = list(outs), set()
    for i in donate:
        s = args[i]
        for j, o in enumerate(outs):
            if j in taken or o.shape != s.shape or o.dtype != s.dtype:
                continue
            taken.add(j)
            if not _same_buffer(o, s):
                with torch.no_grad():
                    s.copy_(o)
                outs[j] = s.detach()
            break
    return tuple(outs)


def _side(dev):
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def _capture(full, fn, args, donate):
    t0 = time.perf_counter()
    dev = args[0].device
    static = tuple(_static(x) for x in args)
    side = _side(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), _tracing([static[i] for i in donate]):
        _outputs(fn(*static))  # the warm-up, outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    # what `torch.cuda.graph` does on entry, done first so the reading
    # below sees only the private pool
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with _tracing([static[i] for i in donate]) as trace:
            with torch.cuda.graph(graph, stream=side):
                outs = _donate(_outputs(fn(*static)), static, donate)
    except BaseException:
        del _SIDE[dev]  # the next capture starts on a fresh stream
        raise
    pool = torch.cuda.memory_reserved(dev) - reserved
    STATS["captures"] += 1
    return _Entry(full, graph, static, outs, trace.checks, fn,
                  (time.perf_counter() - t0) * 1e3, pool)


def _debug_canary():
    from warp_rnnt_tpu_torch.functional.postprocess import (
        _canary_debug_enabled,
    )

    return _canary_debug_enabled()


class CompiledStep:
    """``fn`` compiled once per shape (see the module docstring).  `entry`
    is the `_Entry` the last call replayed (None where it ran eagerly)."""

    def __init__(self, fn, key, donate_argnums):
        self.fn, self.key = fn, key
        self.donate = tuple(sorted({int(i) for i in donate_argnums}))
        self.entry = None

    def __call__(self, *args):
        if not args or not all(isinstance(x, torch.Tensor) for x in args):
            raise TypeError("a compiled step takes one or more tensors")
        if any(not 0 <= i < len(args) for i in self.donate):
            raise ValueError(f"donate_argnums {self.donate} outside the"
                             f" {len(args)} arguments")
        dev = args[0].device
        if any(x.device != dev for x in args):
            devices = sorted({str(x.device) for x in args})
            raise ValueError("a compiled step's arguments must be on one"
                             f" device, got {devices}")
        if dev.type != "cuda" or _EAGER_ON_CARD:
            self.entry = None
            return _outputs(self.fn(*args))
        full = self._cache_key(args)
        entry = _CACHE.get(full)
        if entry is None:
            entry = _capture(full, self.fn, args, self.donate)
            _CACHE[full] = entry
            while len(_CACHE) > CACHE_SIZE:
                _CACHE.popitem(last=False)
        _CACHE.move_to_end(full)
        with torch.no_grad():
            for s, x in zip(entry.args, args):
                if not _same_buffer(s, x):
                    s.copy_(x)
                    STATS["input_copies"] += 1
        self.entry = entry
        return entry.replay()

    def _cache_key(self, args):
        """The key of the graph that ``args`` select (module docstring)."""
        return (self.key, self.donate, str(args[0].device),
                tuple((tuple(x.shape), x.dtype, x.requires_grad)
                      for x in args),
                torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                _flags(), _debug_canary())

    def release(self):
        """Drop the cached graphs of this step's key and donation (their
        static buffers and pools go back to the allocator)."""
        for full in [k for k in _CACHE if k[:2] == (self.key, self.donate)]:
            del _CACHE[full]
        self.entry = None


def compiled_step(fn, *, key, donate_argnums=()):
    """``fn`` compiled once per shape on a CUDA device, eager on the CPU.

    Args:
      fn: (*tensors) -> tuple of tensors; may run autograd inside.
      key: hashable and not None, naming what ``fn`` closes over (see the
        module docstring); required on every device.
      donate_argnums: indices of the arguments whose buffers the outputs
        of their shape and dtype come back in.

    Returns:
      A `CompiledStep`: ``step(*tensors) -> tuple of tensors``.  On a CUDA
      device the outputs are the graph's static tensors, valid until the
      next call.
    """
    if key is None:
        raise ValueError("compiled_step needs a key naming what fn closes"
                         " over: a cached graph replays its first capture's")
    return CompiledStep(fn, key, donate_argnums)


@contextlib.contextmanager
def _plain():
    """Within the block, compiled steps on a CUDA device run ``fn``
    eagerly, as on the CPU: the plain version that the graphs are held
    against (`benchmarks/compiled_serving_cases.py`) and the benchmarks'
    eager readings."""
    global _EAGER_ON_CARD
    saved, _EAGER_ON_CARD = _EAGER_ON_CARD, True
    try:
        yield
    finally:
        _EAGER_ON_CARD = saved


def entries():
    """The cached graphs, least recently used first."""
    return list(_CACHE.values())


def clear():
    """Drop every cached graph (their pools go back to the allocator)."""
    _CACHE.clear()
