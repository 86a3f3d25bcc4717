"""Profiling and measurement helpers on `torch.profiler` (counterpart of
`warp_rnnt_tpu/utils/profiling.py`).

  * `trace(path)`: a context manager that runs `torch.profiler.profile`
    (the host's ops, and the device's kernels where a CUDA device is
    present) and writes a chrome trace, ``*.pt.trace.json``, under
    ``path``; on a CUDA device the trace opens with
    `profile_loss.pad_session`'s spin kernels, which take the records the
    profiler loses at a session's start;
  * `op_breakdown(trace_dir)`: the newest trace under ``trace_dir``,
    summed by name: the device's kernels (the pad left out), copies and
    sets on a CUDA trace, the host's ops (``cpu_op``) on a CPU trace;
  * `device_memory_stats()`: the device's memory under the JAX package's
    key names (``{}`` for the CPU, as JAX gives for a device without
    stats);
  * `peak_memory_mb(fn, *args)`: the memory one call of ``fn`` holds at
    its peak, measured on the card (the JAX package's
    `compiled_memory_mb` reads it from the compiler; torch has no such
    analysis);
  * `timeit(fn, *args)`: dependency-forced ms per call
    (`benchmarks.timing.bench_scalar_chain`);
  * `card_line()`: the card's name and power limit as nvidia-smi prints
    them, the line every measurement stands beside.

`benchmarks.profile_loss` keeps `device_profile` and `profile_step`, the
per-call device time by kernel that the benchmarks report.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import subprocess

import torch

# The chrome trace's event categories of device work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(path: str):
    """Profile the block and write its chrome trace under ``path`` (made if
    missing).  Yields the `torch.profiler.profile` object."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from warp_rnnt_tpu_torch.benchmarks.profile_loss import pad_session

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(path)) as prof:
        if torch.cuda.is_available():
            pad_session()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _newest_trace(trace_dir: str) -> str:
    files = [f for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pattern),
                                recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {trace_dir}")
    return max(files, key=lambda f: (os.path.getmtime(f), f))


def op_breakdown(trace_dir: str, top: int = 25):
    """Durations summed by name from the newest trace under ``trace_dir``.

    Returns a list of (total microseconds, name), longest first.  A trace
    that holds device events (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
    gives those; a CPU trace gives its ``cpu_op`` events.  The profiler's
    own spans (``ProfilerStep#n`` and `record_function` annotations) are
    left out, as the JAX package leaves out its ``jit`` wrappers, and so
    is `trace`'s pad."""
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import PAD_KERNEL

    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    cats = DEVICE_CATS if any(e.get("cat") in DEVICE_CATS for e in events) \
        else ("cpu_op",)
    dur = collections.Counter()
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") in cats and not name.startswith("ProfilerStep")
                and PAD_KERNEL not in name):
            dur[name] += e["dur"]
    return [(d, name) for name, d in dur.most_common(top)]


def device_memory_stats(device=None):
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
    "bytes_limit"} of a CUDA device (default: the current one, or the CPU
    where there is none), from the caching allocator's counters and
    `torch.cuda.mem_get_info`; ``{}`` for a CPU device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": total}


def _tensors(obj):
    """The tensors of a nested argument: tensors, a module's parameters and
    buffers, and the members of lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def argument_bytes(*args) -> int:
    """Bytes of the distinct tensors in ``args`` (`_tensors`)."""
    seen = {}
    for t in _tensors(args):
        seen[(t.device, t.data_ptr())] = t.numel() * t.element_size()
    return sum(seen.values())


def peak_memory_mb(fn, *args) -> float:
    """MiB that one call of ``fn(*args)`` holds at its peak: the arguments,
    the temporaries and the outputs, the JAX package's
    `compiled_memory_mb` sum without its aliasing term (torch donates
    nothing).  Measured, not compiled: the call runs once on the card
    after `torch.cuda.reset_peak_memory_stats()`, and the result is
    (peak allocated bytes - bytes allocated before the call + the
    arguments' bytes).  Needs a CUDA device; the arguments' tensors must
    be on it."""
    if not torch.cuda.is_available():
        raise RuntimeError("peak_memory_mb needs a CUDA device")
    device = next((t.device for t in _tensors(args) if t.is_cuda), None)
    if device is None:
        raise ValueError("peak_memory_mb: no argument tensor is on a CUDA"
                         " device")
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del out
    return (peak - before + argument_bytes(*args)) / 2**20


def timeit(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn(*args)``, each call forced by a data dependency
    (a scalar accumulator sums all of fn's outputs), as the two-point
    marginal of `benchmarks.timing.bench_scalar_chain`."""
    from warp_rnnt_tpu_torch.benchmarks.timing import bench_scalar_chain

    return bench_scalar_chain(fn, args, iters, warmup=warmup)


def card_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (say "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def card() -> dict:
    """{"device": the card's name, "power_limit": its limit}, both from
    `card_line`."""
    name, _, limit = card_line().rpartition(",")
    return {"device": name.strip(), "power_limit": limit.strip()}
