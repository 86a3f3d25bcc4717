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
"""

from __future__ import annotations

import argparse
import time

import torch

from warp_rnnt_tpu_torch import rnnt_loss

ITERS = 10
SEED = 0
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
    windows), "wall_ms", "busy_ms" (per call), "idle_share",
    "kernels_per_call", "rows": [(device ms per call, launches per call,
    kernel name)], "device"}."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_loss needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

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
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # ops also report their kernels
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / ITERS, ev.count // ITERS, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"step_ms": min(step_ms), "wall_ms": wall_ms / ITERS,
            "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms * ITERS / wall_ms,
            "kernels_per_call": sum(r[1] for r in rows), "rows": rows,
            "device": torch.cuda.get_device_name(0)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("main", *CASES), default="main")
    args = parser.parse_args(argv)
    r = profile(args.path)
    print(f"{r['device']} path={args.path}: {ITERS} calls, step"
          f" {r['step_ms']:.4f} ms/call without the profiler, wall"
          f" {r['wall_ms']:.4f} ms/call, device busy {r['busy_ms']:.4f}"
          f" ms/call, idle share {r['idle_share']:.3f},"
          f" {r['kernels_per_call']} kernels/call")
    for ms, count, key in r["rows"]:
        print(f"{ms:10.4f} ms/call {count:4d} x/call"
              f" {ms / r['wall_ms']:6.3f} of wall  {key[:90]}")


if __name__ == "__main__":
    main()
