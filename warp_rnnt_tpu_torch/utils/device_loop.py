"""A loop that runs on the device: the port's counterpart of
``jax.lax.while_loop`` (no JAX file; the JAX package leaves its loops to
XLA).

`while_loop(cond, body, state, consts, max_iterations=..., key=...)` runs
``state = body(state, consts)`` while ``cond(state, consts)``, a 0-d bool
tensor, holds.  ``state`` and ``consts`` are tuples of tensors; ``body``
returns a new tuple of the state's shapes and dtypes and changes nothing
in place.  ``consts`` are the loop's inputs (a decoder's encoder frames,
frame bounds, stream position), which the body reads and never writes.

The loop runs in rounds of `UNROLL` masked steps (`unrolled(n)` sets
another number within a block: the tests and the benchmarks' sweeps).
Each step is

    go = cond(state, consts)
    new = body(state, consts)
    state = tuple(torch.where(go, n, o) for n, o in zip(new, state))
    iterations += go                      # a device int32

The mask is global, JAX's ``cond`` and not a mask per sample, so a step
taken after JAX's loop would have stopped leaves every field as it was,
bit for bit, and every step before that point is the body unchanged: the
result equals ``lax.while_loop``'s for any unroll and any number of
surplus steps.

With ``folded=True`` the body applies that mask itself: ``body(state,
consts, count) -> (state, count)`` must return the whole state and the
count unchanged, bit for bit, where ``cond(state, consts)`` is false, and
its new state and ``count + 1`` where ``cond`` holds (the decoders' step
kernels compute ``cond`` from the step's inputs and write their inputs
through; `models.decoding`).  A step is then the body alone, with no
``cond``, ``torch.where`` or add of its own, and the guarantee above holds
as it is.  In both modes the host reads ``cond`` of the new state and the
iteration count after a round, together, once; it stops when ``cond`` is
false.  So a loop of n iterations reads the device max(1, ceil(n /
unroll)) times, where a Python ``while`` on ``cond`` reads it n + 1 times.

  * On the CPU (the tests, and any caller that asks for the CPU) the
    rounds run eagerly: this is the plain version, the same Python step
    that the graph captures.
  * On a CUDA device the state and the consts are copied into static
    buffers, one round is warmed up on a side stream and captured into one
    `torch.cuda.CUDAGraph` (ending with ``copy_`` of the new state into
    the static buffers), and the graph is replayed; after each replay the
    round's flag and count come back through a pinned buffer and an event.
    A failure to capture or replay raises: nothing on a CUDA tensor falls
    back to the eager loop, which runs on the card only inside `_plain()`
    (the tests' and `chip_smoke.py`'s plain version).

Graphs are cached, least recently used first out past `CACHE_SIZE`, by
the caller's ``key`` (which must name what the body closes over: its model
and that model's parameter addresses, its static arguments; it is
required, since a cached entry replays the ``cond`` and ``body`` of its
first capture), whether the body is folded, the shapes and dtypes of the
state and the consts, the unroll, the device, inference mode, and the
TF32 and reduced-precision flags of cuBLAS and cuDNN, which change the
products' bits (`cache_key`).  An entry holds ``cond`` and ``body``, and so
whatever they close over, until it leaves the cache or `clear()` empties
it.  Only the copied-back state may be read after a replay: everything
else the body allocates lives in the graph's private pool.  A loop's
`LoopStats.graph` is the entry it replayed (None where it ran eagerly),
for the benchmarks: `_Entry.replay()` replays its round once more.

Passing ``max_iterations`` raises RuntimeError: the caller derives it from
the loop's own bound, so it is a fault, not a long loop.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import NamedTuple

import torch

UNROLL = 16  # masked steps a round (a graph); `unrolled()` sets another
CACHE_SIZE = 32  # graphs kept
STATS = {"captures": 0}  # graphs captured since import

_CACHE = collections.OrderedDict()
_SIDE = {}  # one capture stream a device (cuBLAS keeps a workspace a stream)
_EAGER_ON_CARD = False  # set only inside `_plain()`


class LoopStats(NamedTuple):
    iterations: int  # steps in which cond held (JAX's trip count)
    host_reads: int  # device-to-host reads of the loop's flag
    graph: object = None  # the `_Entry` replayed; None where run eagerly


class _Entry:
    """One captured round: its graph, its static buffers, and what it
    cost to make (host ms of the warm-up and capture; bytes the graph's
    private pool reserved)."""

    def __init__(self, key, unroll, graph, state, consts, count, status,
                 host, refs, capture_ms, pool_bytes):
        self.key, self.unroll, self.graph = key, unroll, graph
        self.state, self.consts = state, consts
        self.count, self.status, self.host = count, status, host
        self.event = torch.cuda.Event()
        self.refs = refs
        self.capture_ms, self.pool_bytes = capture_ms, pool_bytes

    def replay(self):
        """One more round from the static buffers as they stand (after a
        finished loop every step of it is masked)."""
        self.graph.replay()


def _round(cond, body, state, consts, count, unroll, folded):
    """``unroll`` masked steps -> (state, count, cond of the new state);
    a ``folded`` body masks its own steps and counts them."""
    for _ in range(unroll):
        if folded:
            state, count = body(state, consts, count)
            continue
        go = cond(state, consts)
        new = body(state, consts)
        state = tuple(torch.where(go, n, o) for n, o in zip(new, state))
        count = count + go
    return state, count, cond(state, consts)


def _status(go, count):
    return torch.stack([go.to(torch.int32), count])


def _check_bound(go, iterations, max_iterations):
    if iterations + go > max_iterations:
        raise RuntimeError(
            f"while_loop: {iterations} iterations{' and cond holds' * go},"
            f" past its bound of {max_iterations}")


def _eager(cond, body, state, consts, max_iterations, unroll, folded):
    count = torch.zeros((), dtype=torch.int32, device=state[0].device)
    reads = 0
    while True:
        state, count, go = _round(cond, body, state, consts, count, unroll,
                                  folded)
        go, iterations = _status(go, count).tolist()
        reads += 1
        _check_bound(go, iterations, max_iterations)
        if not go:
            return state, LoopStats(iterations, reads)


def _flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, m.allow_fp16_reduced_precision_reduction,
            m.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def _spec(xs):
    return tuple((tuple(x.shape), x.dtype) for x in xs)


def _static(x):
    return x.clone(memory_format=torch.contiguous_format)


def cache_key(key, unroll, device, state, consts, folded=False):
    """The graph cache's key of a loop (module docstring): two loops share
    a graph only where every part of it is equal."""
    return (key, bool(folded), unroll, str(device), _spec(state),
            _spec(consts), torch.is_inference_mode_enabled(), _flags())


def _capture(key, cond, body, state, consts, unroll, folded):
    t0 = time.perf_counter()
    dev = state[0].device
    state = tuple(_static(x) for x in state)
    consts = tuple(_static(c) for c in consts)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.zeros((2,), dtype=torch.int32, device=dev)
    host = torch.zeros((2,), dtype=torch.int32, pin_memory=True)
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    side = _SIDE[dev]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # lazy inits (cuBLAS workspace) off capture
        _round(cond, body, state, consts, count, unroll, folded)
    torch.cuda.current_stream(dev).wait_stream(side)
    # what `torch.cuda.graph` does on entry, done first so the reading
    # below sees only the private pool
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        new, n, go = _round(cond, body, state, consts, count, unroll,
                            folded)
        for s, v in zip(state, new):
            s.copy_(v)
        count.copy_(n)
        status.copy_(_status(go, n))
    pool = torch.cuda.memory_reserved(dev) - reserved
    STATS["captures"] += 1
    return _Entry(key, unroll, graph, state, consts, count, status, host,
                  (cond, body), (time.perf_counter() - t0) * 1e3, pool)


def _graphed(cond, body, state, consts, max_iterations, unroll, key,
             folded):
    full = cache_key(key, unroll, state[0].device, state, consts, folded)
    entry = _CACHE.get(full)
    if entry is None:
        entry = _capture(full, cond, body, state, consts, unroll, folded)
        _CACHE[full] = entry
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
    _CACHE.move_to_end(full)
    for s, x in zip(entry.state, state):
        s.copy_(x)
    for c, x in zip(entry.consts, consts):
        c.copy_(x)
    entry.count.zero_()
    reads = 0
    while True:
        entry.graph.replay()
        entry.host.copy_(entry.status, non_blocking=True)
        entry.event.record()
        entry.event.synchronize()
        reads += 1
        go, iterations = entry.host.tolist()
        _check_bound(go, iterations, max_iterations)
        if not go:
            break
    return (tuple(s.clone() for s in entry.state),
            LoopStats(iterations, reads, entry))


def while_loop(cond, body, state, consts=(), *, max_iterations: int, key,
               folded: bool = False):
    """Run ``body`` while ``cond`` holds (see the module docstring).

    Args:
      cond: (state, consts) -> 0-d bool tensor on the state's device.
      body: (state, consts) -> new state, a tuple like ``state``; with
        ``folded``, (state, consts, count) -> (new state, new count), the
        step masked by ``cond`` and counted by the body itself.
      state: tuple of tensors, the loop's carry; the caller's tensors are
        not written.
      consts: tuple of tensors the body reads.
      max_iterations: the loop's bound; a loop that needs more raises.
      key: hashable and not None, what ``cond`` and ``body`` close over:
        with the shapes it keys the graph cache on CUDA, and it is
        required on every device.
      folded: the body masks and counts its own steps (module docstring).

    Returns:
      (the final state, `LoopStats`).
    """
    if key is None:
        raise ValueError("while_loop needs a key naming what cond and body"
                         " close over: a cached graph replays its first"
                         " capture's")
    unroll = UNROLL
    state, consts = tuple(state), tuple(consts)
    if state[0].device.type == "cuda" and not _EAGER_ON_CARD:
        return _graphed(cond, body, state, consts, max_iterations, unroll,
                        key, folded)
    return _eager(cond, body, state, consts, max_iterations, unroll, folded)


@contextlib.contextmanager
def unrolled(unroll: int):
    """Within the block, `while_loop` takes ``unroll`` masked steps a
    round.  Not thread-safe: for the tests and the benchmarks' sweeps."""
    global UNROLL
    if int(unroll) < 1:
        raise ValueError(f"unroll must be at least 1, got {unroll}")
    saved, UNROLL = UNROLL, int(unroll)
    try:
        yield
    finally:
        UNROLL = saved


@contextlib.contextmanager
def _plain():
    """Within the block, loops on a CUDA device run eagerly, as on the
    CPU: the plain version that the graphed loop is held against."""
    global _EAGER_ON_CARD
    saved, _EAGER_ON_CARD = _EAGER_ON_CARD, True
    try:
        yield
    finally:
        _EAGER_ON_CARD = saved


def entries():
    """The cached graphs, least recently used first."""
    return list(_CACHE.values())


def pool_mb():
    """MiB reserved by the cached graphs' private pools at capture."""
    return sum(e.pool_bytes for e in _CACHE.values()) / 2 ** 20


def clear():
    """Drop every cached graph (their pools go back to the allocator)."""
    _CACHE.clear()
