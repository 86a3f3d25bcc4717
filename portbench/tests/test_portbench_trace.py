"""The trace's arithmetic on hand-made events: the union of the device's
intervals, the time of named kernels, the breakdown's ops and gaps, and
the readers that take a trace."""

import importlib.util
import os

from portbench import trace

DEVICE = [("lattice_kernel<2>", 0, 10), ("flat_write_kernel<float>", 5, 20),
          ("lattice_kernel<2>", 30, 35), ("epilogue_kernel<float>", 50, 52)]
HOST = [("cudaLaunchKernel", 21, 29), ("cudaStreamSynchronize", 36, 60)]


def test_busy_is_the_union():
    assert trace.busy_ns(DEVICE) == 20 + 5 + 2
    assert trace.busy_ns(DEVICE, 8, 32) == 12 + 2


def test_kernel_time_by_name():
    assert trace.kernel_ns(DEVICE, ("lattice_kernel",)) == 15
    assert trace.kernel_ns(DEVICE, ("lattice_kernel", "epilogue")) == 17
    assert trace.kernel_ns(DEVICE, ("no_such",)) == 0


def test_breakdown():
    ops = trace.top_ops(DEVICE, k=3)
    assert sorted(ops[:2]) == [["flat_write_kernel<float>", 15e-9],
                               ["lattice_kernel<2>", 15e-9]]
    assert ops[2] == ["epilogue_kernel<float>", 2e-9]
    gaps = trace.idle_gaps(DEVICE, HOST)
    assert gaps == [["cudaStreamSynchronize", 15e-9],
                    ["cudaLaunchKernel", 10e-9]]


class _Tr:
    device, host = DEVICE, HOST


def _reader(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(traced=True):
    return {"trace": _Tr() if traced else None, "window_s": 60e-9,
            "calls": 2, "units": 8, "latencies_s": [1.0, 2.0, 3.0],
            "setup_s": 4.0, "peak_bytes": 2**31, "rates": (1e9, 1e9, 1e9),
            "cell": {"N": 1, "T": 2, "U": 3, "V": 4, "calls": 2,
                     "valid_cells": 5, "spans_s": [0.5, 1.0, 1.5]}}


def test_readers():
    assert abs(_reader("device_idle_pct.train")(_ctx()) - 55.0) < 1e-9
    # 16 B a valid cell over 1 GB/s, against 17 ns of those kernels
    assert abs(_reader("lattice_roofline")(_ctx()) - 100 * 80 / 17) < 1e-9
    assert _reader("loss.kernels_per_call")(_ctx()) == 2.0
    assert _reader("peak_mem_gib")(_ctx()) == 2.0
    assert _reader("train_utt_per_s")(_ctx()) == 8 / 60e-9
    assert abs(_reader("decode_p95_ms")(_ctx()) - 2900.0) < 1e-9
    ctx = _ctx()
    ctx["calls"] = 3  # three requests, their spans 0.5 + 1.0 + 1.5 s
    assert abs(_reader("decode.device_ms_per_request")(ctx) - 1000.0) < 1e-9
    assert abs(_reader("decode.host_ms_per_request")(ctx) - 1000.0) < 1e-9
    ctx["window_s"] = 6.0
    assert abs(_reader("device_idle_pct.decode")(ctx) - 50.0) < 1e-9


def test_readers_read_nothing_without_a_trace():
    for name in ("device_idle_pct.train", "lattice_roofline",
                 "grad_write_roofline", "loss_call_roofline",
                 "mfu.train_step",
                 "loss.kernels_per_call", "device_idle_pct.decode",
                 "decode.device_ms_per_request",
                 "decode.host_ms_per_request"):
        assert _reader(name)(_ctx(traced=False)) is None, name
