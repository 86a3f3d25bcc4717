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

Where a folded loop's ``cond`` is an `AnyLess` (``any(state[i] <
consts[j])`` over int32 vectors: the decoders' "some sample has frames
left"), the card ends each round in one launch: the captured round is its
steps alone, the last of them writing the loop's static buffers itself
(``body(state, consts, count, into=(*static_state, static_count))``,
which must return those tensors, or views of them, holding what it would
have returned), and ``loop_continue_kernel`` computes ``cond`` from the
static t and bound, writes the status and sets the node's condition
(`_card_round`, `_continue_plain`: their plain versions).  At unroll 1 the
round's one step reads the static buffers, so it writes fresh tensors and
the round copies them in.  Any other loop keeps the round's tail: the last
``cond``, the copies back, the status.

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
    after each round ``loop_continue_kernel`` counts the round in the
    status's third int, applies the same rule as `_continues` on the
    device and sets the node's condition.  A loop is one graph launch,
    with no host read between its rounds, and one read of the status after
    it, for the bound check, `LoopStats` and the rounds it ran
    (`_Entry.rounds`).  The
    round may hold only the node kinds a conditional body takes
    (`BODY_KINDS`); a round with any other kind, and a failure to capture,
    build or launch, raises: nothing on a CUDA tensor falls back to the
    eager loop, which runs on the card only inside `_plain()` (the tests'
    and `chip_smoke.py`'s plain version).
  * Where the current stream is capturing a CUDA graph (a compiled step's
    capture, `utils.compiled_step`: a whole decode or streaming chunk, as
    JAX jits the whole function around its ``lax.while_loop``), the same
    while node becomes a node of that graph (`csrc/device_loop.cu`
    `device_loop_capture`): the loop's inputs are copied into the round's
    static buffers and its final state cloned out of them inside the
    capture, so each replay of the outer graph runs the whole loop, and
    the one host read of the status, with the bound check, runs after
    each replay (`compiled_step.after_replay`).  The round's entry must
    be cached already: the compiled step's warm-up, which runs before its
    capture (a capture cannot nest), captured it; a missing entry
    raises.  Both the warm-up's loop and the captured one tell the
    compiled step which entry they ran (`traced_loop`), so that it keeps
    its graph where it holds a while node, and a replay's launches can be
    counted from the graphs (`kernel_names`, `_Entry.round_kernels`,
    `_Entry.rounds`).

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
while node is freed when it leaves the cache or `clear()` empties it.  A
compiled step that captured the loop holds its entry (its after-replay
check closes over it) and replays a clone of the round of its own, so
neither eviction nor `clear()` reaches it: they free only the entry's own
while node.
Only the copied-back state may be read after a loop: everything else the
body allocates lives in the graph's private pool.  A loop's
`LoopStats.graph` is the entry it launched (None where it ran eagerly),
for the benchmarks: `_Entry.replay()` replays one round of it once more,
`_Entry.load()` then `_Entry.launch()` runs one whole loop from given
inputs.  ``on_read``, where given, receives each loop's `LoopStats` after
its host read: at the return of an eager or graphed loop, and after each
replay of a compiled step that captured it (the loop's own return then
gives LoopStats(0, 0, entry): nothing ran yet).

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
# round on the card (`_Entry.rounds`: the rounds of the last loop read); a
# while node added to a capture (`_Entry.insert`) launches nothing there
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
_NODE_ROUNDS = None  # a list inside `_host_node()`


class AnyLess:
    """A loop ``cond``: ``any(state[state_index] < consts[const_index])``,
    a 0-d bool tensor.  Where a folded loop's cond is one and both are
    int32 vectors of one length, the card takes it
    (``loop_continue_kernel``, module docstring)."""

    __slots__ = ("state_index", "const_index")

    def __init__(self, state_index, const_index):
        self.state_index, self.const_index = state_index, const_index

    def __call__(self, state, consts):
        return (state[self.state_index] < consts[self.const_index]).any()


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
                       ("device_loop_kernel_names",
                        [i64, ctypes.c_char_p, i64, p64]),
                       ("device_loop_build", [i64, p64, p64, p64]),
                       ("device_loop_capture", [i64, i64, p64]),
                       ("device_loop_edge_probe", [p64]),
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


def edge_probe():
    """{"from_child_graph", "from_kernel": the CUDA error (0: taken) of a
    programmatic edge into a kernel node inside a conditional while
    node's body, from a child graph node (the round as the loop adds it)
    or from a kernel node} (`csrc/device_loop.cu`
    `device_loop_edge_probe`; scratch graphs, nothing launched)."""
    out = (ctypes.c_longlong * 2)()
    _check(_lib().device_loop_edge_probe(out), "device_loop_edge_probe")
    return {"from_child_graph": int(out[0]), "from_kernel": int(out[1])}


def kernel_names(raw_graph):
    """{kernel name (mangled): nodes} of a raw ``cudaGraph_t`` (a
    `CUDAGraph(keep_graph=True)`'s ``raw_cuda_graph()``), child graphs
    walked, a conditional node's body not."""
    cap, size = 1 << 16, ctypes.c_longlong()
    while True:
        buf = ctypes.create_string_buffer(cap)
        _check(_lib().device_loop_kernel_names(raw_graph, buf, cap,
                                               ctypes.byref(size)),
               "device_loop_kernel_names")
        if size.value <= cap:
            return collections.Counter(
                buf.raw[:size.value].decode().splitlines())
        cap = size.value


class _Entry:
    """One captured round and the while node built on it: the round's
    torch graph, its static buffers (state, consts, count, the status:
    cond, count and the rounds run, the bound), the while node's exec, the
    body's node kinds and (programmatic, all) edges of its round, and what
    it cost to make (host ms of the warm-up, capture and build; bytes the
    graph's private pool reserved).  `rounds`: the rounds of the last loop
    read (`read`), as ``loop_continue_kernel`` counted them on the card.
    `card_cond`: (state index, const index) where the card takes the
    loop's cond (the round has no tail), else None; `loop_args`: the
    buffers' addresses ``loop_continue_kernel`` reads (`_loop_args`)."""

    def __init__(self, key, unroll, graph, exec_, state, consts, count,
                 status, bound, refs, kinds, edges, capture_ms, pool_bytes,
                 card_cond=None, loop_args=None):
        self.key, self.unroll, self.graph = key, unroll, graph
        self.card_cond, self.loop_args = card_cond, loop_args
        self.exec = exec_
        self.state, self.consts = state, consts
        self.count, self.status, self.bound = count, status, bound
        self.host = torch.zeros((3,), dtype=torch.int32, pin_memory=True)
        self.rounds = 0
        self._round_kernels = None
        self.event = torch.cuda.Event()
        self.refs = refs
        self.kinds, self.edges = kinds, edges
        self.capture_ms, self.pool_bytes = capture_ms, pool_bytes

    def load(self, state, consts, max_iterations):
        """Copy a loop's inputs into the static buffers, zero the count
        and the status (its rounds among them) and write the bound."""
        for s, x in zip(self.state, state):
            s.copy_(x)
        for c, x in zip(self.consts, consts):
            c.copy_(x)
        self.count.zero_()
        self.status.zero_()
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

    def insert(self):
        """The whole loop from the static buffers as they will stand, as
        one node of the graph the current stream is capturing (nothing is
        launched, so nothing is counted: each replay of that graph runs
        the loop, `rounds` counts its rounds)."""
        dev = self.count.device.index
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(_build.on_device(dev, lambda a: _lib().device_loop_capture(*a),
                                (stream, self.graph.raw_cuda_graph(),
                                 self.loop_args)),
               "device_loop_capture")

    def read(self):
        """(cond, iterations) after a loop, and its rounds into `rounds`:
        the one host read (in inference mode, where the buffers were made:
        a compiled step may run this after a replay outside it)."""
        with torch.inference_mode():
            self.host.copy_(self.status, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        go, iterations, self.rounds = self.host.tolist()
        return go, iterations

    def round_kernels(self):
        """{kernel name: nodes} of one round (`kernel_names` of the
        captured round, which the while node's body runs once a round
        before ``loop_continue_kernel``)."""
        if self._round_kernels is None:
            self._round_kernels = kernel_names(self.graph.raw_cuda_graph())
        return self._round_kernels

    def replay(self):
        """One more round from the static buffers as they stand (after a
        finished loop every step of it is masked)."""
        self.graph.replay()

    def close(self):
        """Free the while node (the torch graph and the buffers stay while
        the entry lives, so a compiled step that captured the loop, and
        holds the entry, replays on)."""
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


def _same(x, s):
    """``x`` is the static buffer ``s`` (or a view of all of it)."""
    return x.data_ptr() == s.data_ptr() and x.numel() == s.numel()


def _card_round(body, state, consts, count, unroll, static, static_count):
    """One round of a loop whose cond the card takes (module docstring):
    ``unroll`` folded steps from ``state`` and ``count``, the last writing
    ``static`` and ``static_count`` (``into=``) where it does not read
    them (unroll > 1); what a step left elsewhere (at unroll 1, all of
    it) is copied in.  No cond, no status: ``loop_continue_kernel`` (on
    the host, `_continue_plain`) takes them from the static buffers."""
    for i in range(unroll):
        if i == unroll - 1 and unroll > 1:
            state, count = body(state, consts, count,
                                into=(*static, static_count))
        else:
            state, count = body(state, consts, count)
    for s, x in zip((*static, static_count), (*state, count)):
        if not _same(x, s):
            s.copy_(x)


def _continue_plain(status, bound, count, t, fb):
    """``loop_continue_kernel``'s plain version where it takes the cond:
    the status's cond any(t < fb) and its count written, the round counted
    in status[2], and the stop rule (`_continues`) applied: True to run
    another round."""
    status[0] = (t < fb).any().to(torch.int32)
    status[1] = count
    status[2] += 1
    return _continues(int(status[0]), int(status[1]), int(bound))


def _card_cond(cond, folded, state, consts):
    """(state index, const index) where the card takes the loop's cond: a
    folded loop whose cond is an `AnyLess` over int32 vectors of one
    length; else None."""
    if not folded or not isinstance(cond, AnyLess):
        return None
    t, fb = state[cond.state_index], consts[cond.const_index]
    if (t.dtype == fb.dtype == torch.int32 and t.dim() == 1
            and t.shape == fb.shape):
        return cond.state_index, cond.const_index
    return None


def _node_plain(cond, body, state, consts, max_iterations, unroll, card):
    """A loop whose cond the card takes, as its while node runs it, on any
    device (the CPU tests' plain version of the node): the inputs copied
    into static buffers, rounds of `_card_round` each followed by
    `_continue_plain` (the first round runs whatever cond is at entry, as
    the node's), one read of the status at the end.  Returns (state,
    `LoopStats`, the rounds run)."""
    dev = state[0].device
    static = tuple(_static(x) for x in state)
    consts = tuple(_static(c) for c in consts)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.zeros((3,), dtype=torch.int32, device=dev)
    bound = torch.full((), max_iterations, dtype=torch.int32, device=dev)
    t, fb = static[card[0]], consts[card[1]]
    while True:
        _card_round(body, static, consts, count, unroll, static, count)
        if not _continue_plain(status, bound, count, t, fb):
            break
    go, iterations, rounds = status.tolist()
    _check_bound(go, iterations, max_iterations)
    return (tuple(s.clone() for s in static), LoopStats(iterations, 1),
            rounds)


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


def _loop_args(status, bound, count, t=None, fb=None):
    """The buffers ``loop_continue_kernel`` reads (csrc `LoopArgs`):
    status, bound, and where the card takes the cond, count, t and frame
    bound and their length; a ctypes int64 array."""
    card = t is not None
    return (ctypes.c_longlong * 6)(
        status.data_ptr(), bound.data_ptr(), count.data_ptr(),
        t.data_ptr() if card else 0, fb.data_ptr() if card else 0,
        t.numel() if card else 0)


def _while_node(graph, loop_args, index):
    """The while node's exec over a captured round (`csrc/device_loop.cu`
    `device_loop_build`; ``loop_args`` from `_loop_args`) -> (exec, the
    round's `body_kinds`, (programmatic, all) edges of the body's round).
    A round holding a node kind a conditional body does not take raises
    before the build."""
    kinds = body_kinds(graph)
    bad = {k: n for k, n in kinds.items() if k not in BODY_KINDS}
    if bad:
        raise RuntimeError(f"while_loop: the captured round holds {bad},"
                           " which a conditional node's body does not take")
    exec_, edges = ctypes.c_longlong(), (ctypes.c_longlong * 2)()
    _check(_build.on_device(
        index, lambda a: _lib().device_loop_build(*a),
        (graph.raw_cuda_graph(), loop_args, ctypes.byref(exec_), edges)),
        "device_loop_build")
    return exec_.value, kinds, (int(edges[0]), int(edges[1]))


def _capture(key, cond, body, state, consts, unroll, folded):
    t0 = time.perf_counter()
    dev = state[0].device
    card = _card_cond(cond, folded, state, consts)
    state = tuple(_static(x) for x in state)
    consts = tuple(_static(c) for c in consts)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.zeros((3,), dtype=torch.int32, device=dev)
    bound = torch.zeros((), dtype=torch.int32, device=dev)
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    side = _SIDE[dev]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # lazy inits (cuBLAS workspace) off capture
        if card is None:
            _round(cond, body, state, consts, count, unroll, folded)
        else:
            _card_round(body, state, consts, count, unroll, state, count)
    torch.cuda.current_stream(dev).wait_stream(side)
    # what `torch.cuda.graph` does on entry, done first so the reading
    # below sees only the private pool
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        if card is None:
            new, n, go = _round(cond, body, state, consts, count, unroll,
                                folded)
            for s, v in zip(state, new):
                s.copy_(v)
            count.copy_(n)
            status[:2].copy_(_status(go, n))
        else:
            _card_round(body, state, consts, count, unroll, state, count)
    pool = torch.cuda.memory_reserved(dev) - reserved
    args = (_loop_args(status, bound, count) if card is None else
            _loop_args(status, bound, count, state[card[0]], consts[card[1]]))
    exec_, kinds, edges = _while_node(graph, args, dev.index)
    STATS["captures"] += 1
    return _Entry(key, unroll, graph, exec_, state, consts, count, status,
                  bound, (cond, body), kinds, edges,
                  (time.perf_counter() - t0) * 1e3, pool, card, args)


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
    traced_loop(entry)
    entry.load(state, consts, max_iterations)
    entry.launch()
    go, iterations = entry.read()
    _check_bound(go, iterations, max_iterations)
    return (tuple(s.clone() for s in entry.state),
            LoopStats(iterations, 1, entry))


def _captured(cond, body, state, consts, max_iterations, unroll, key,
              folded, on_read):
    """The loop as a node of the graph being captured (module
    docstring)."""
    from warp_rnnt_tpu_torch.utils.compiled_step import after_replay

    full = cache_key(key, unroll, state[0].device, state, consts, folded)
    entry = _CACHE.get(full)
    if entry is None:
        raise RuntimeError("while_loop under a CUDA graph capture: the loop's"
                           " round has no cached graph (a compiled step's"
                           " warm-up captures it before the capture)")
    _CACHE.move_to_end(full)
    traced_loop(entry)
    entry.load(state, consts, max_iterations)
    entry.insert()
    out = tuple(s.clone() for s in entry.state)

    def check():
        go, iterations = entry.read()
        _check_bound(go, iterations, max_iterations)
        if on_read is not None:
            on_read(LoopStats(iterations, 1, entry))

    after_replay(check)
    return out, LoopStats(0, 0, entry)


def traced_loop(entry):
    """Tell a compiled step being traced, if any, that its ``fn`` ran the
    loop of ``entry`` (`utils.compiled_step.note_loop`)."""
    from warp_rnnt_tpu_torch.utils.compiled_step import note_loop

    note_loop(entry)


def while_loop(cond, body, state, consts=(), *, max_iterations: int, key,
               folded: bool = False, on_read=None):
    """Run ``body`` while ``cond`` holds (see the module docstring).

    Args:
      cond: (state, consts) -> 0-d bool tensor on the state's device.
      body: (state, consts) -> new state, a tuple like ``state``; with
        ``folded``, (state, consts, count) -> (new state, new count), the
        step masked by ``cond`` and counted by the body itself (and, where
        ``cond`` is an `AnyLess`, taking ``into=``: module docstring).
      state: tuple of tensors, the loop's carry; the caller's tensors are
        not written.
      consts: tuple of tensors the body reads.
      max_iterations: the loop's bound; a loop that needs more raises.
      key: hashable and not None, what ``cond`` and ``body`` close over:
        with the shapes it keys the graph cache on CUDA, and it is
        required on every device.
      folded: the body masks and counts its own steps (module docstring).
      on_read: None, or a callable that receives each loop's `LoopStats`
        after its host read (module docstring).

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
        if torch.cuda.is_current_stream_capturing():
            return _captured(cond, body, state, consts, max_iterations,
                             unroll, key, folded, on_read)
        out = _graphed(cond, body, state, consts, max_iterations, unroll,
                       key, folded)
    else:
        card = (_card_cond(cond, folded, state, consts)
                if _NODE_ROUNDS is not None else None)
        if card is None:
            out = _eager(cond, body, state, consts, max_iterations, unroll,
                         folded)
        else:
            new, stats, rounds = _node_plain(cond, body, state, consts,
                                             max_iterations, unroll, card)
            _NODE_ROUNDS.append(rounds)
            out = (new, stats)
    if on_read is not None:
        on_read(out[1])
    return out


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


@contextlib.contextmanager
def _host_node():
    """Within the block, a loop off the card (or inside `_plain()`) whose
    cond the card would take runs `_node_plain`, the while node's round
    and ``loop_continue_kernel`` in plain torch, one read a loop: the
    CPU's view of the card's route.  Yields a list that receives each such
    loop's rounds."""
    global _NODE_ROUNDS
    saved, _NODE_ROUNDS = _NODE_ROUNDS, []
    try:
        yield _NODE_ROUNDS
    finally:
        _NODE_ROUNDS = saved


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
