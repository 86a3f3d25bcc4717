"""The loss+grad paths of one tree on a CUDA device, for comparing two trees
in turns.

    python -m warp_rnnt_tpu_torch.benchmarks.main_path_turns [--tag x]
        [--only headline,table,compact,fused]

Prints one JSON line a measurement, each with the tag:
  * "headline": `bench_loss.headline()`'s chained ms (N=32, T=150, 20
    labels, V=5000, fp32), and one loss+grad under the profiler
    (`profile_loss.profile`): kernels a call by name, device busy ms (the
    device ms), idle share, and 1 - busy / chained.
  * "table": warp-rnnt's README rows (T=150, 40 labels, V=28; T=150, 20
    labels, V=5000; T=1500, 300 labels, V=50) at N=1 and N=128:
    loss+grad and no-grad chained ms (`bench_loss.run_loss_bench`, the
    `run_table` iterations), and at N=128 the loss+grad under the profiler
    (`bench_loss.profile_row`).
  * "compact": cases A and B (`packed_step.measure`).
  * "fused": the fused slice (`fused_step.measure`).

It reads only entry points that older trees have, so a copy placed in an
older tree's `benchmarks/` and run there (that tree's root on PYTHONPATH)
times that tree: parent, change, change, parent, one process each.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

TABLE = ((150, 40, 28), (150, 20, 5000), (1500, 300, 50))
TABLE_N = (1, 128)
PARTS = ("headline", "table", "compact", "fused")


def _profile_keys(prof, chained_ms):
    return {"kernels_per_call": prof["kernels_per_call"],
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "one_minus_busy_over_chained": 1 - prof["busy_ms"] / chained_ms,
            "complete": prof["complete"],
            "kernels": [(round(ms, 5), n, key[:70])
                        for ms, n, key in prof["rows"]]}


def headline():
    from warp_rnnt_tpu_torch.benchmarks import bench_loss, profile_loss

    ms = bench_loss.headline()["value"]
    return {"chained_ms": ms, **_profile_keys(profile_loss.profile("main"), ms)}


def table_row(T, L, V, N):
    from warp_rnnt_tpu_torch.benchmarks import bench_loss, run_table

    iters = run_table.iters_for(T, L)
    out = {"T": T, "L": L, "V": V, "N": N,
           "loss_grad_ms": bench_loss.run_loss_bench(N, T, L, V, iters)}
    torch.cuda.empty_cache()
    out["fwd_ms"] = bench_loss.run_loss_bench(N, T, L, V, iters, grad=False)
    torch.cuda.empty_cache()
    if N == TABLE_N[-1]:
        prof = bench_loss.profile_row(N, T, L, V)["loss_grad"]
        out.update(_profile_keys(prof, out["loss_grad_ms"]))
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--only", default=",".join(PARTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("main_path_turns needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = args.only.split(",")
    dev = torch.cuda.get_device_name(0)

    def emit(what, r):
        print(json.dumps({"tag": args.tag, "what": what, "device": dev, **r}),
              flush=True)

    if "headline" in parts:
        emit("headline", headline())
    if "table" in parts:
        for T, L, V in TABLE:
            for N in TABLE_N:
                emit("table", table_row(T, L, V, N))
    if "compact" in parts:
        from warp_rnnt_tpu_torch.benchmarks import packed_step

        for case in ("A", "B"):
            r = packed_step.measure(case)
            emit("compact", {"case": case, **{k: r[k] for k in (
                "loss_grad_ms", "no_grad_ms", "kernels_per_call", "busy_ms",
                "idle_share")}})
            torch.cuda.empty_cache()
    if "fused" in parts:
        from warp_rnnt_tpu_torch.benchmarks import fused_step

        emit("fused", fused_step.measure())


if __name__ == "__main__":
    main()
