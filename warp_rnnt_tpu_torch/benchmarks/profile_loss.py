"""Where the time of one loss+grad call goes, on a CUDA device.

    python -m warp_rnnt_tpu_torch.benchmarks.profile_loss [--path main|A|B]

``main`` (the default) runs `rnnt_loss(log_probs (32, 150, 21, 5000), ...,
reduction="mean", gather=True)` + backward; ``A`` and ``B`` run the compact
layout, `rnnt_loss(xs (rows, V), ..., compact=True, reduction="mean")` +
backward, at the two full-width cases of `chip_smoke.py` (A: N=32, T=150,
20 labels, V=5000; B: N=16, T=1500, 300 labels, V=50; random lengths).
Each runs under `torch.profiler`, and the script prints the device time of
each kernel summed over the window, per call, with its share of the
window's wall time, and the device's idle share.  The wall time includes
the profiler's own host cost, so it reads higher than the chained time of
`chip_smoke.py`; beside it stands the step's wall time without the
profiler (best of three windows of ITERS calls).  It reads only entry
points that older trees have, so a copy placed in an older tree's
`benchmarks/` times that tree.  Needs a CUDA device.

The profiler (kineto) loses the first kernel records of a session, the
more the more sessions the process has run, and now and then a chunk of
records further in (up to a call's).  So a session opens with `PAD` empty
spin kernels, which take the first loss and are left out of the counts,
and it is run again (up to `ATTEMPTS` times) until every kernel's count
is a multiple of the calls profiled; `device_profile` says whether it got
there ("complete") and how many of the pad were lost ("pad_lost").
"""

from __future__ import annotations

import argparse
import time
import warnings

import torch

from warp_rnnt_tpu_torch import rnnt_loss

ITERS = 10
SEED = 0
PAD = 128  # spin kernels opening a profiled session
PAD_KERNEL = "spin_kernel"  # `torch.cuda._sleep`'s kernel, in no step
ATTEMPTS = 3
CASES = {"A": dict(N=32, T=150, L=20, V=5000), "B": dict(N=16, T=1500, L=300, V=50)}


def _main_step():
    N, T, U, V = 32, 150, 21, 5000
    g = torch.Generator(device="cuda").manual_seed(SEED)
    log_probs = torch.log_softmax(
        torch.randn(N, T, U, V, generator=g, device="cuda"), dim=-1
    )
    labels = torch.randint(1, V, (N, U - 1), generator=g, device="cuda",
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    yn = torch.full((N,), U - 1, dtype=torch.int32, device="cuda")

    def step():
        x = log_probs.detach().requires_grad_()
        rnnt_loss(x, labels, xn, yn, reduction="mean", gather=True).backward()
        return x.grad

    return step


def _compact_step(case):
    from warp_rnnt_tpu_torch.benchmarks.packed_cases import full_case

    c = full_case(**CASES[case], seed=SEED)

    def step():
        x = c["xs"].detach().requires_grad_()
        rnnt_loss(x, c["ys"], c["xn"], c["yn"], compact=True,
                  reduction="mean").backward()
        return x.grad

    return step


def profile(path="main"):
    """Profile ITERS calls of one path's loss+grad step (`profile_step`)."""
    return profile_step(_main_step() if path == "main" else _compact_step(path))


def profile_step(step):
    """Profile ITERS calls of ``step()`` after three unprofiled ones.
    Returns {"step_ms" (wall per call without the profiler, best of three
    windows), and `device_profile`'s keys}."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_loss needs a CUDA device")
    for _ in range(3):
        step()
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / ITERS)
    return {"step_ms": min(step_ms), **device_profile(step, ITERS)}


def pad_session():
    """Launch `PAD` empty spin kernels and wait for them: the records a
    profiler session loses first are theirs."""
    for _ in range(PAD):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def kernel_rows(events, iters):
    """(rows, complete, pad count) from ``events``, (key, device events,
    device us): rows (device ms per call, launches per call, key), longest
    first, the pad left out; complete when some of the pad and some kernel
    are there and every count is a multiple of ``iters``."""
    rows, pads = [], 0
    for key, count, dev_us in events:
        if PAD_KERNEL in key:
            pads += count
        elif dev_us > 0:
            rows.append((dev_us / 1e3 / iters, count, key))
    complete = pads > 0 and bool(rows) and all(c % iters == 0
                                               for _, c, _ in rows)
    rows = [(ms, c // iters, key) for ms, c, key in rows]
    return sorted(rows, reverse=True), complete, pads


def _profile_once(step, iters, cpu):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    with torch_profile(activities=activities) as prof:
        pad_session()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # ops also report their kernels
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        events.append((ev.key, ev.count, dev_us))
    rows, complete, pads = kernel_rows(events, iters)
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms / iters, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms * iters / wall_ms,
            "kernels_per_call": sum(r[1] for r in rows), "rows": rows,
            "complete": complete, "pad_lost": PAD - pads,
            "device": torch.cuda.get_device_name(0)}


def device_profile(step, iters, cpu=True):
    """Run ``iters`` calls of ``step()`` under `torch.profiler` (host ops
    too unless ``cpu`` is False: a call of tens of thousands of launches
    traces faster without them), after `pad_session`, up to `ATTEMPTS`
    times until the session is complete (see the module docstring).
    Returns {"wall_ms" (per call, the profiler's host cost included),
    "busy_ms" (per call), "idle_share", "kernels_per_call", "rows":
    [(device ms per call, launches per call, kernel name)], "complete",
    "pad_lost", "attempts", "device"}."""
    for attempt in range(1, ATTEMPTS + 1):
        r = _profile_once(step, iters, cpu)
        if r["complete"]:
            break
    else:
        warnings.warn(f"device_profile: a kernel's count is not a multiple of"
                      f" {iters} calls after {ATTEMPTS} sessions; the counts"
                      " and busy time miss records")
    return {**r, "attempts": attempt}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("main", *CASES), default="main")
    args = parser.parse_args(argv)
    r = profile(args.path)
    print(f"{r['device']} path={args.path}: {ITERS} calls, step"
          f" {r['step_ms']:.4f} ms/call without the profiler, wall"
          f" {r['wall_ms']:.4f} ms/call, device busy {r['busy_ms']:.4f}"
          f" ms/call, idle share {r['idle_share']:.3f},"
          f" {r['kernels_per_call']} kernels/call, complete {r['complete']}"
          f" after {r['attempts']} attempt(s), pad lost {r['pad_lost']}")
    for ms, count, key in r["rows"]:
        print(f"{ms:10.4f} ms/call {count:4d} x/call"
              f" {ms / r['wall_ms']:6.3f} of wall  {key[:90]}")


if __name__ == "__main__":
    main()
