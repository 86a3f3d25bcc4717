"""The port's `utils/profiling.py` (the counterpart of the JAX package's
`utils/profiling.py`, on `torch.profiler`), on the CPU:

  * `trace` + `op_breakdown` on a small CPU computation give (us, name)
    pairs, longest first, naming the ops that ran;
  * `op_breakdown` on a hand-written CUDA-style chrome trace sums the
    device events (kernels, copies, sets) by name and leaves out the host
    ops, the profiler's own spans and `trace`'s pad, from the newest
    trace, gzipped or not;
  * `profile_loss.kernel_rows` (what `device_profile` reads from a
    session) leaves the pad out and calls a session complete only when
    every kernel's count is a multiple of the calls;
  * `device_memory_stats` is ``{}`` for the CPU, as JAX's is for a device
    without stats; `argument_bytes` counts each tensor once;
  * `timeit` and `peak_memory_mb` refuse to give a number without CUDA.
"""

import gzip
import json
import os
import time

import pytest
import torch

from warp_rnnt_tpu_torch.utils import profiling


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_trace_and_op_breakdown_on_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("block"):
            for _ in range(3):
                torch.tanh(a @ a)
    rows = profiling.op_breakdown(str(tmp_path))
    assert rows and all(isinstance(us, (int, float)) for us, _ in rows)
    times = [us for us, _ in rows]
    assert times == sorted(times, reverse=True)
    names = {name for _, name in rows}
    assert {"aten::tanh", "aten::mm"} <= names
    assert "block" not in names and not any(n.startswith("ProfilerStep")
                                            for n in names)
    assert len(profiling.op_breakdown(str(tmp_path), top=2)) == 2


def _event(name, cat, dur, ts=0):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": ts,
            "pid": 0, "tid": 0}


@pytest.mark.parametrize("gz", [False, True])
def test_op_breakdown_sums_device_events(tmp_path, gz):
    events = [_event("lattice_kernel", "kernel", 3.5),
              _event("flat_write_kernel", "kernel", 10.0),
              _event("lattice_kernel", "kernel", 4.0),
              _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1.0),
              _event("Memset (Device)", "gpu_memset", 0.5),
              _event("aten::add", "cpu_op", 100.0),
              _event("ProfilerStep#3", "user_annotation", 500.0),
              _event("block", "gpu_user_annotation", 400.0),
              _event("at::cuda::(anonymous namespace)::spin_kernel(long)",
                     "kernel", 2.0),
              {"ph": "i", "name": "marker", "cat": "kernel"}]
    older = tmp_path / "a" / "old.pt.trace.json"
    older.parent.mkdir()
    older.write_text(json.dumps(
        {"traceEvents": [_event("stale", "kernel", 9e9)]}))
    past = time.time() - 100
    os.utime(older, (past, past))
    doc = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(tmp_path / "host.1.pt.trace.json.gz", "wt") as f:
            f.write(doc)
    else:
        (tmp_path / "host.1.pt.trace.json").write_text(doc)
    assert profiling.op_breakdown(str(tmp_path)) == [
        (10.0, "flat_write_kernel"), (7.5, "lattice_kernel"),
        (1.0, "Memcpy HtoD (Pageable -> Device)"), (0.5, "Memset (Device)")]


@pytest.mark.parametrize("lost,pads,complete", [
    (0, 125, True), (1, 125, False), (10, 125, True), (0, 0, False)])
def test_kernel_rows_pad_and_completeness(lost, pads, complete):
    from warp_rnnt_tpu_torch.benchmarks import profile_loss as pl

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [(spin, pads, 0.5), ("flat_write_kernel", 10 - lost, 600.0),
              ("lattice_kernel", 20, 80.0), ("Memset (Device)", 10, 0.0)]
    rows, got_complete, got_pads = pl.kernel_rows(events, 10)
    assert got_pads == pads and got_complete == complete
    assert pl.kernel_rows(events[:1], 10)[1] is False  # no kernel at all
    assert rows == sorted(rows, reverse=True)
    assert rows[0] == (0.06, (10 - lost) // 10, "flat_write_kernel")
    assert rows[1] == (0.008, 2, "lattice_kernel")
    assert len(rows) == 2  # the pad and the zero-time set left out


def test_op_breakdown_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.op_breakdown(str(tmp_path))


def test_device_memory_stats_on_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_argument_bytes_counts_each_tensor_once():
    a = torch.zeros(10)
    lin = torch.nn.Linear(3, 2)
    assert profiling.argument_bytes(a, [a, {"x": a}]) == 40
    assert profiling.argument_bytes(lin, torch.zeros(2, dtype=torch.int64)) == (
        (3 * 2 + 2) * 4 + 16)


@pytest.mark.parametrize("fn", ["timeit", "peak_memory_mb"])
def test_timers_need_cuda(fn):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(profiling, fn)(torch.sin, torch.zeros(4))
