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
    inside `_plain()` (the plain version the graphs are held against) or
    `utils.device_loop._plain()` (a loop run eagerly reads the host each
    round, which no capture can hold).

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

State updated in place.  A step may update tensors that are not its
arguments, as a train step updates the parameters and the optimizer's
moments (JAX's donated ``params`` and ``opt_state``): ``state``, a
callable that names them, makes the warm-up leave no trace.  Before the
warm-up each tensor that ``state()`` names is copied aside; after it each
goes back to that value in place (``copy_``, so the graph captures the
live addresses), and a tensor that the warm-up created (``state()`` names
it afterwards, not before: AdamW's ``step``, ``exp_avg`` and
``exp_avg_sq`` on a fresh optimizer) is zeroed, its initial value.  So
the first call of a shape updates the state once, by the replay, as every
later call does (`_undone`).  A gradient the step reads back is the
step's own business: a train step sets them to None first
(``zero_grad(set_to_none=True)``), so the capture allocates them in the
graph's pool, as torch's whole-network capture does.  Whatever replaces a
state tensor (``load_state_dict``, ``model.to``) needs a new key or a
`release`: the graph writes the addresses it captured.

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
A host read inside ``fn`` cannot be captured: the compact layout reads
nothing while traced (`tracing()`) and needs static bounds then, as
under JAX's jit (`functional/compact.py`).  A check that must read
the host registers itself with `after_replay` while the step is traced
and runs after each replay: the loss's canary (``WARP_RNNT_DEBUG``) warns
after the replay of a call that trips it, as an eager call does.  A
`utils.device_loop.while_loop` inside ``fn`` is captured whole, as one
conditional while node of the graph: its bound check and its one host
read are such a check, and the check holds the loop's round (its graph
and buffers, which the node reads) for as long as the entry lives.  Where
``fn``'s warm-up ran such a loop, the graph is kept beside its executable
(``keep_graph``), so that its nodes can be counted by kind
(`utils.device_loop.body_kinds(entry.graph)`) and a replay's launches
read from it (`_Entry.loops`: the loops' entries, each with its round's
kernels and the rounds of its last read).

Not thread-safe: one thread at a time captures and replays.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from warp_rnnt_tpu_torch.utils import device_loop as _device_loop
from warp_rnnt_tpu_torch.utils.device_loop import _flags

CACHE_SIZE = 32  # graphs kept
STATS = {"captures": 0, "replays": 0, "input_copies": 0}

_CACHE = collections.OrderedDict()
_EAGER_ON_CARD = False  # set only inside `_plain()`
_SIDE = {}  # one capture stream a device (cuBLAS keeps a workspace a stream)
_TRACE = None  # the `_Trace` of the warm-up or capture under way


def module_key(module):
    """(data_ptr, dtype, shape) of each parameter and buffer of ``module``
    and of its submodules, walked on every call (however a tensor was
    replaced, its address shows): the part of a key that names a module a
    step closes over."""
    out = []
    _walk(module, out)
    return tuple(out)


def _walk(module, out):
    for tensors in (module._parameters, module._buffers):
        for t in tensors.values():
            if t is not None:
                out.append((t.data_ptr(), t.dtype, t.shape))
    for child in module._modules.values():
        if child is not None:
            _walk(child, out)


class _Trace:
    """What a warm-up or capture of ``fn`` records: the donated buffers
    not yet taken, as (data_ptr, bytes), the host checks to run after
    each replay, and the device loops' entries it ran (`note_loop`)."""

    def __init__(self, donated):
        self.donated = [(x.data_ptr(), x.numel() * x.element_size())
                        for x in donated]
        self.checks = []
        self.loops = []


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


def note_loop(entry):
    """Record that the ``fn`` being traced, if any, ran the device loop of
    `utils.device_loop` entry ``entry``."""
    if _TRACE is not None:
        _TRACE.loops.append(entry)


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
    checks to run after a replay, the device loops' entries the graph
    holds as while nodes, and what it cost to make (host ms of the
    warm-up and capture; bytes the graph's private pool reserved)."""

    def __init__(self, key, graph, args, outputs, checks, loops, fn,
                 capture_ms, pool_bytes):
        self.key, self.graph = key, graph
        self.args, self.outputs, self.checks = args, outputs, checks
        self.loops = loops
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


@contextlib.contextmanager
def _undone(state):
    """Within the block the tensors that ``state()`` names may change; on
    leaving, each goes back in place to its value on entry, and one that
    ``state()`` did not name on entry is zeroed (module docstring).  A
    ``state`` of None names nothing."""
    if state is None:
        yield
        return
    with torch.no_grad():
        saved = {id(t): (t, t.detach().clone()) for t in state()}
    try:
        yield
    finally:
        with torch.no_grad():
            for t in state():
                if id(t) in saved:
                    t.copy_(saved[id(t)][1])
                else:
                    t.zero_()


def _capture(full, fn, args, donate, state):
    t0 = time.perf_counter()
    dev = args[0].device
    static = tuple(_static(x) for x in args)
    side = _side(dev)
    cur = torch.cuda.current_stream(dev)
    with _undone(state):  # copied aside and restored on the caller's stream
        side.wait_stream(cur)
        with torch.cuda.stream(side), _tracing(
                [static[i] for i in donate]) as warm:
            _outputs(fn(*static))  # the warm-up, outside the capture
        cur.wait_stream(side)
    # what `torch.cuda.graph` does on entry, done first so the reading
    # below sees only the private pool
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    keep = bool(warm.loops)  # the graph will hold a while node
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    try:
        with _tracing([static[i] for i in donate]) as trace:
            with torch.cuda.graph(graph, stream=side):
                outs = _donate(_outputs(fn(*static)), static, donate)
        if keep:
            graph.instantiate()
    except BaseException:
        del _SIDE[dev]  # the next capture starts on a fresh stream
        raise
    pool = torch.cuda.memory_reserved(dev) - reserved
    STATS["captures"] += 1
    return _Entry(full, graph, static, outs, trace.checks, trace.loops, fn,
                  (time.perf_counter() - t0) * 1e3, pool)


def _debug_canary():
    from warp_rnnt_tpu_torch.functional.postprocess import (
        _canary_debug_enabled,
    )

    return _canary_debug_enabled()


class CompiledStep:
    """``fn`` compiled once per shape (see the module docstring).  `entry`
    is the `_Entry` the last call replayed (None where it ran eagerly)."""

    def __init__(self, fn, key, donate_argnums, state=None):
        self.fn, self.key, self.state = fn, key, state
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
        if runs_eagerly(dev):
            self.entry = None
            return _outputs(self.fn(*args))
        full = self._cache_key(args)
        entry = _CACHE.get(full)
        if entry is None:
            entry = _capture(full, self.fn, args, self.donate, self.state)
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


def runs_eagerly(device) -> bool:
    """True where a compiled step's call on ``device`` runs ``fn`` eagerly
    (the CPU; on the card inside `_plain()` or
    `utils.device_loop._plain()`), False where it replays a graph."""
    return (torch.device(device).type != "cuda" or _EAGER_ON_CARD
            or _device_loop._EAGER_ON_CARD)


def compiled_step(fn, *, key, donate_argnums=(), state=None):
    """``fn`` compiled once per shape on a CUDA device, eager on the CPU.

    Args:
      fn: (*tensors) -> tuple of tensors; may run autograd inside.
      key: hashable and not None, naming what ``fn`` closes over (see the
        module docstring); required on every device.
      donate_argnums: indices of the arguments whose buffers the outputs
        of their shape and dtype come back in.
      state: None, or a callable () -> iterable of the tensors that ``fn``
        updates in place (a train step's parameters and optimizer state):
        the warm-up before a capture leaves them as it found them, so a
        call updates them once (module docstring).

    Returns:
      A `CompiledStep`: ``step(*tensors) -> tuple of tensors``.  On a CUDA
      device the outputs are the graph's static tensors, valid until the
      next call.
    """
    if key is None:
        raise ValueError("compiled_step needs a key naming what fn closes"
                         " over: a cached graph replays its first capture's")
    return CompiledStep(fn, key, donate_argnums, state)


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
