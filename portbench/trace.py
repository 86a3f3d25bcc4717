"""The device trace of a window: `torch.profiler` over the timed calls.

`Tracer` opens a profiler session on the card's activities alone (the
kernels, copies and sets, and the CUDA runtime calls that launch them;
no host operator records), pads its start with spin kernels, whose
records are the ones a session loses first, and reads back the raw
events: the device's intervals and the runtime's, in nanoseconds.
`busy_ns` is the union of the device's intervals; `top_ops` and
`idle_gaps` are the result line's breakdown.
"""

from __future__ import annotations

import bisect
import collections

import torch

PAD = 128  # spin kernels that open a session
PAD_KERNEL = "spin_kernel"  # `torch.cuda._sleep`'s kernel


class Tracer:
    """``with Tracer() as tr:`` profiles the block; afterwards ``tr.device``
    is [(name, start_ns, end_ns)] of the device's work and ``tr.host``
    the runtime calls, both sorted by start."""

    def __init__(self):
        self.device, self.host = [], []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(PAD):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType

        for ev in self._prof.profiler.kineto_results.events():
            name = ev.name()
            if hasattr(ev, "start_ns"):
                start, dur = ev.start_ns(), ev.duration_ns()
            else:
                start, dur = ev.start_us() * 1000, ev.duration_us() * 1000
            if ev.device_type() == DeviceType.CUDA:
                if PAD_KERNEL not in name:
                    self.device.append((name, start, start + dur))
            else:
                self.host.append((name, start, start + dur))
        self.device.sort(key=lambda e: e[1])
        self.host.sort(key=lambda e: e[1])


def busy_ns(device, lo=None, hi=None) -> int:
    """The union of the device intervals, clipped to [lo, hi]."""
    total, end = 0, None
    for _, s, e in device:
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_ns(device, names) -> int:
    """The device time of the events whose name holds one of ``names``
    (the union of their intervals)."""
    return busy_ns([ev for ev in device if any(n in ev[0] for n in names)])


def top_ops(device, k: int = 10):
    """[[name, seconds]] of the device operations that took most time,
    summed by name."""
    by = collections.Counter()
    for name, s, e in device:
        by[name] += e - s
    return [[name[:120], ns / 1e9] for name, ns in by.most_common(k)]


def idle_gaps(device, host, k: int = 10):
    """[[name, seconds]] of the longest idle gaps between device
    operations, each named by the runtime call the host was in at the
    gap's middle ("host" where it was in none)."""
    gaps, end = [], None
    for _, s, e in device:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    starts = [h[1] for h in host]
    out = []
    for length, s, e in gaps[:k]:
        mid = (s + e) // 2
        j = bisect.bisect_right(starts, mid)
        name = next((host[i][0] for i in range(j - 1, max(j - 65, -1), -1)
                     if host[i][2] >= mid), "host")
        out.append([name[:120], length / 1e9])
    return out
