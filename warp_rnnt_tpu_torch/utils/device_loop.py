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
as it is.  In both modes a round ends by writing ``cond`` of the new state
and the iteration count into one two-int status on the device.

  * On the CPU (the tests, and any caller that asks for the CPU) the
    rounds run eagerly, and the host reads the status after each round
    and goes on while ``cond`` holds and the count is under
    ``max_iterations`` (`_continues`): a loop of n iterations reads the
    device max(1, ceil(n / unroll)) times.  This is the plain version,
    the same Python step that the graph captures.
  * On a CUDA device the state and the consts are copied into static
    buffers, one round is warmed up on a side stream and captured into one
    `torch.cuda.CUDAGraph` (ending with ``copy_`` of the new state into
    the static buffers and the status), and that round becomes the body
    of one CUDA graph conditional while node (`csrc/device_loop.cu`):
    after each round ``loop_continue_kernel`` applies the same rule as
    `_continues` on the device and sets the node's condition.  A loop is
    one graph launch, with no host read between its rounds, and one read
    of the status after it, for the bound check and `LoopStats`.  The
    round may hold only the node kinds a conditional body takes
    (`BODY_KINDS`); a round with any other kind, and a failure to capture,
    build or launch, raises: nothing on a CUDA tensor falls back to the
    eager loop, which runs on the card only inside `_plain()` (the tests'
    and `chip_smoke.py`'s plain version).

Graphs are cached, least recently used first out past `CACHE_SIZE`, by
the caller's ``key`` (which must name what the body closes over: its model
and that model's parameter addresses, its static arguments; it is
required, since a cached entry replays the ``cond`` and ``body`` of its
first capture), whether the body is folded, the shapes and dtypes of the
state and the consts, the unroll, the device, inference mode, and the
TF32 and reduced-precision flags of cuBLAS and cuDNN, which change the
products' bits (`cache_key`).  An entry holds ``cond`` and ``body``, and so
whatever they close over, and the round's torch graph, whose private pool
holds every address the while node reads, for as long as it lives; its
while node is freed when it leaves the cache or `clear()` empties it.
Only the copied-back state may be read after a loop: everything else the
body allocates lives in the graph's private pool.  A loop's
`LoopStats.graph` is the entry it launched (None where it ran eagerly),
for the benchmarks: `_Entry.replay()` replays one round of it once more,
`_Entry.load()` then `_Entry.launch()` runs one whole loop from given
inputs.

Passing ``max_iterations`` raises RuntimeError: the caller derives it from
the loop's own bound, so it is a fault, not a long loop.  On the card the
while node stops at the first round that ends at or past the bound, so a
faulty loop stops on the device, and the host raises after its one read.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import time
from typing import NamedTuple

import torch

from warp_rnnt_tpu_torch.ops import _build

UNROLL = 16  # masked steps a round; `unrolled()` sets another
CACHE_SIZE = 32  # graphs kept
STATS = {"captures": 0}  # graphs captured since import
# while launches (`_Entry.launch`): each runs loop_continue_kernel once a
# round on the card
LAUNCHES = {"loop_continue_kernel": 0}

# cudaGraphNodeType by value (`csrc/device_loop.cu` `device_loop_nodes`;
# 30: a type past these, 31: a memcpy that is not device to device), and
# the kinds a conditional node's body takes
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional",
              30: "other", 31: "memcpy_host"}
BODY_KINDS = frozenset({"kernel", "memcpy", "memset", "graph", "empty",
                        "conditional"})

_CACHE = collections.OrderedDict()
_SIDE = {}  # one capture stream a device (cuBLAS keeps a workspace a stream)
_EAGER_ON_CARD = False  # set only inside `_plain()`


class LoopStats(NamedTuple):
    iterations: int  # steps in which cond held (JAX's trip count)
    host_reads: int  # device-to-host reads of the loop's flag
    graph: object = None  # the `_Entry` launched; None where run eagerly


@functools.cache
def _lib():
    """`csrc/device_loop.cu`'s library (built at first use), its entries
    typed."""
    lib = _build.load("device_loop")
    i64, p64 = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
    for name, args in (("device_loop_nodes", [i64, p64]),
                       ("device_loop_build", [i64, i64, i64, p64, p64]),
                       ("device_loop_launch", [i64, i64]),
                       ("device_loop_destroy", [i64])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.device_loop_error_string.argtypes = [ctypes.c_int]
    lib.device_loop_error_string.restype = ctypes.c_char_p
    return lib


def _check(code, what):
    _build.check(_lib(), "device_loop_error_string", code, what)


def body_kinds(graph):
    """{kind: nodes} of a captured `torch.cuda.CUDAGraph(keep_graph=True)`,
    child graphs walked (`NODE_KINDS`)."""
    counts = (ctypes.c_longlong * 32)()
    _check(_lib().device_loop_nodes(graph.raw_cuda_graph(), counts),
           "device_loop_nodes")
    return {NODE_KINDS.get(k, str(k)): int(n)
            for k, n in enumerate(counts) if n}


class _Entry:
    """One captured round and the while node built on it: the round's
    torch graph, its static buffers (state, consts, count, the status, the
    bound), the while node's exec, the body's node kinds and (programmatic,
    all) edges of its round, and what it cost to make (host ms of the
    warm-up, capture and build; bytes the graph's private pool
    reserved)."""

    def __init__(self, key, unroll, graph, exec_, state, consts, count,
                 status, bound, refs, kinds, edges, capture_ms, pool_bytes):
        self.key, self.unroll, self.graph = key, unroll, graph
        self.exec = exec_
        self.state, self.consts = state, consts
        self.count, self.status, self.bound = count, status, bound
        self.host = torch.zeros((2,), dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()
        self.refs = refs
        self.kinds, self.edges = kinds, edges
        self.capture_ms, self.pool_bytes = capture_ms, pool_bytes

    def load(self, state, consts, max_iterations):
        """Copy a loop's inputs into the static buffers, zero the count
        and write the bound."""
        for s, x in zip(self.state, state):
            s.copy_(x)
        for c, x in zip(self.consts, consts):
            c.copy_(x)
        self.count.zero_()
        self.bound.fill_(max_iterations)

    def launch(self):
        """One whole loop from the static buffers as they stand: one
        launch of the while node on the current stream."""
        if self.exec is None:
            raise RuntimeError("while_loop: this graph was freed (it left"
                               " the cache)")
        dev = self.count.device.index
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(_build.on_device(dev, lambda a: _lib().device_loop_launch(*a),
                                (self.exec, stream)), "device_loop_launch")
        LAUNCHES["loop_continue_kernel"] += 1

    def read(self):
        """(cond, iterations) after a loop: the one host read."""
        self.host.copy_(self.status, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return self.host.tolist()

    def replay(self):
        """One more round from the static buffers as they stand (after a
        finished loop every step of it is masked)."""
        self.graph.replay()

    def close(self):
        """Free the while node (the torch graph stays while the entry
        lives)."""
        if self.exec is not None:
            torch.cuda.synchronize(self.count.device)
            _check(_lib().device_loop_destroy(self.exec),
                   "device_loop_destroy")
            self.exec = None


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


def _continues(go, iterations, max_iterations):
    """The loop's stop rule after a round, the plain version of
    ``loop_continue_kernel``: go on while cond holds and the count is
    under the bound."""
    return bool(go) and iterations < max_iterations


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
        if not _continues(go, iterations, max_iterations):
            _check_bound(go, iterations, max_iterations)
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


def _while_node(graph, status, bound):
    """The while node's exec over a captured round (`csrc/device_loop.cu`
    `device_loop_build`) -> (exec, the round's `body_kinds`,
    (programmatic, all) edges of the body's round).  A round holding a
    node kind a conditional body does not take raises before the build."""
    kinds = body_kinds(graph)
    bad = {k: n for k, n in kinds.items() if k not in BODY_KINDS}
    if bad:
        raise RuntimeError(f"while_loop: the captured round holds {bad},"
                           " which a conditional node's body does not take")
    exec_, edges = ctypes.c_longlong(), (ctypes.c_longlong * 2)()
    _check(_build.on_device(
        status.device.index, lambda a: _lib().device_loop_build(*a),
        (graph.raw_cuda_graph(), status.data_ptr(), bound.data_ptr(),
         ctypes.byref(exec_), edges)), "device_loop_build")
    return exec_.value, kinds, (int(edges[0]), int(edges[1]))


def _capture(key, cond, body, state, consts, unroll, folded):
    t0 = time.perf_counter()
    dev = state[0].device
    state = tuple(_static(x) for x in state)
    consts = tuple(_static(c) for c in consts)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.zeros((2,), dtype=torch.int32, device=dev)
    bound = torch.zeros((), dtype=torch.int32, device=dev)
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
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        new, n, go = _round(cond, body, state, consts, count, unroll,
                            folded)
        for s, v in zip(state, new):
            s.copy_(v)
        count.copy_(n)
        status.copy_(_status(go, n))
    pool = torch.cuda.memory_reserved(dev) - reserved
    exec_, kinds, edges = _while_node(graph, status, bound)
    STATS["captures"] += 1
    return _Entry(key, unroll, graph, exec_, state, consts, count, status,
                  bound, (cond, body), kinds, edges,
                  (time.perf_counter() - t0) * 1e3, pool)


def _graphed(cond, body, state, consts, max_iterations, unroll, key,
             folded):
    full = cache_key(key, unroll, state[0].device, state, consts, folded)
    entry = _CACHE.get(full)
    if entry is None:
        entry = _capture(full, cond, body, state, consts, unroll, folded)
        _CACHE[full] = entry
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)[1].close()
    _CACHE.move_to_end(full)
    entry.load(state, consts, max_iterations)
    entry.launch()
    go, iterations = entry.read()
    _check_bound(go, iterations, max_iterations)
    return (tuple(s.clone() for s in entry.state),
            LoopStats(iterations, 1, entry))


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
    """Drop every cached graph (their while nodes freed; their pools go
    back to the allocator once nothing holds their entries)."""
    for entry in _CACHE.values():
        entry.close()
    _CACHE.clear()
