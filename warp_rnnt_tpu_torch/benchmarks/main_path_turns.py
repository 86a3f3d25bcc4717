"""The loss+grad paths of one tree on a CUDA device, for comparing two trees
in turns.

    python -m warp_rnnt_tpu_torch.benchmarks.main_path_turns [--tag x]
        [--only headline,table,compact,fused,host,train] [--eager]

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
  * "compact": cases A and B (`packed_step.measure`): eager loss+grad and
    no-grad chained ms, the profile; in pairs, also the loss+grad and the
    no-grad costs compiled with static bounds and eager, in turns, on one
    timer (`packed_step.compiled_readings`).
  * "train": `bench_train` at JAX's shape in each loss mode: chained step
    ms, busy ms, idle share, kernels a step, peak; in pairs the eager and
    the compiled step (`models.compiled_train_step`), each process eager
    then compiled, with the capture ms and pool MiB.
  * "fused": the fused slice (`fused_step.measure`).
  * "host": the eager loss+grad's host path at the headline and the V=28
    rows at N=1 and 128 (`host_path.breakdown`).

In a tree with `utils.compiled_step` the headline and table readings come
in pairs, eager and compiled (the step captured once as a CUDA graph, its
log-probs donated), timed in turns: eager, compiled, compiled, eager, the
no-grad calls likewise, each profile eager and compiled; ``--eager`` reads
the eager side only, the readings an older tree gives, so that eager
turns across trees run the same calls and profiler sessions in the same
order.  The eager readings read only entry points that older trees have
(where `bench_loss` takes ``compiled``, it is passed False), so a copy of
this file and `host_path.py` placed in an older tree's `benchmarks/` and
run there (that tree's root on PYTHONPATH) times that tree's eager path:
parent, change, change, parent, one process each.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json

import torch

TABLE = ((150, 40, 28), (150, 20, 5000), (1500, 300, 50))
TABLE_N = (1, 128)
HOST = ((32, 150, 20, 5000), (1, 150, 40, 28), (128, 150, 40, 28))
PARTS = ("headline", "table", "compact", "fused", "host", "train")
TRAIN_MODES = ("from_logits", "gather", "fused")
TRAIN_KEYS = ("step_ms", "busy_ms", "idle_share", "kernels_per_step",
              "peak_mb", "loss")


def _compiles():
    """Whether this tree compiles its benchmarks' calls."""
    try:
        from warp_rnnt_tpu_torch.utils import compiled_step  # noqa: F401
    except ImportError:
        return False
    return True


def _turns(read, pairs):
    """With ``pairs``, {"eager": [ms, ms], "compiled": [ms, ms]} read eager,
    compiled, compiled, eager by ``read(compiled)``; else {"eager": [ms]}
    (``read(False)``, or ``read(None)`` in a tree that does not compile:
    its own defaults)."""
    if not pairs:
        return {"eager": [read(False if _compiles() else None)]}
    out = {"eager": [], "compiled": []}
    for compiled in (False, True, True, False):
        out["compiled" if compiled else "eager"].append(read(compiled))
        torch.cuda.empty_cache()
    return out


def _kw(compiled):
    return {} if compiled is None else {"compiled": compiled}


def _compiled_kw(fn, compiled):
    """{"compiled": compiled} where ``fn`` takes it (a tree whose
    benchmark compiles), else {} (an older tree's)."""
    return ({"compiled": compiled}
            if "compiled" in inspect.signature(fn).parameters else {})


def _profile_keys(prof, chained_ms):
    return {"kernels_per_call": prof["kernels_per_call"],
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "one_minus_busy_over_chained": 1 - prof["busy_ms"] / chained_ms,
            "complete": prof["complete"],
            "kernels": [(round(ms, 5), n, key[:70])
                        for ms, n, key in prof["rows"]]}


def headline(pairs):
    from warp_rnnt_tpu_torch.benchmarks import bench_loss, profile_loss

    ms = _turns(lambda c: bench_loss.headline(**_kw(c))["value"], pairs)
    out = {"chained_ms": ms["eager"][0], "ms": ms,
           **_profile_keys(profile_loss.profile("main"), min(ms["eager"]))}
    if "compiled" in ms:
        prof = profile_loss.profile("main", compiled=True)
        out["compiled_profile"] = _profile_keys(prof, min(ms["compiled"]))
    return out


def table_row(T, L, V, N, pairs):
    from warp_rnnt_tpu_torch.benchmarks import bench_loss, run_table

    iters = run_table.iters_for(T, L)
    grad = _turns(lambda c: bench_loss.run_loss_bench(N, T, L, V, iters,
                                                      **_kw(c)), pairs)
    fwd = _turns(lambda c: bench_loss.run_loss_bench(N, T, L, V, iters,
                                                     grad=False, **_kw(c)),
                 pairs)
    out = {"T": T, "L": L, "V": V, "N": N,
           "loss_grad_ms": grad["eager"][0], "fwd_ms": fwd["eager"][0],
           "loss_grad": grad, "no_grad": fwd}
    if N == TABLE_N[-1]:
        for c in (False, True) if pairs else (False if _compiles() else None,):
            prof = bench_loss.profile_row(N, T, L, V, **_kw(c))["loss_grad"]
            keys = _profile_keys(prof, min(grad["compiled" if c else "eager"]))
            if c:
                out["compiled_profile"] = keys
            else:
                out.update(keys)
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--only", default=",".join(PARTS))
    parser.add_argument("--eager", action="store_true")
    args = parser.parse_args(argv)
    pairs = _compiles() and not args.eager
    if not torch.cuda.is_available():
        raise SystemExit("main_path_turns needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = args.only.split(",")
    dev = torch.cuda.get_device_name(0)

    def emit(what, r):
        print(json.dumps({"tag": args.tag, "what": what, "device": dev, **r}),
              flush=True)

    if "host" in parts:
        from warp_rnnt_tpu_torch.benchmarks import host_path

        for N, T, L, V in HOST:
            emit("host", {"N": N, "T": T, "L": L, "V": V,
                          **host_path.breakdown(N, T, L, V, compiled=pairs)})
            torch.cuda.empty_cache()
    if "headline" in parts:
        emit("headline", headline(pairs))
    if "table" in parts:
        for T, L, V in TABLE:
            for N in TABLE_N:
                emit("table", table_row(T, L, V, N, pairs))
    if "compact" in parts:
        from warp_rnnt_tpu_torch.benchmarks import packed_step

        for case in ("A", "B"):
            r = packed_step.measure(
                case, **_compiled_kw(packed_step.measure, pairs))
            emit("compact", {"case": case, **{k: r[k] for k in (
                "loss_grad_ms", "no_grad_ms", "kernels_per_call", "busy_ms",
                "idle_share", "compiled") if k in r}})
            torch.cuda.empty_cache()
    if "train" in parts:
        from warp_rnnt_tpu_torch.benchmarks import bench_train

        for mode in TRAIN_MODES:
            r = bench_train.bench_train(
                loss_mode=mode, **_compiled_kw(bench_train.bench_train, pairs))
            out = {"loss_mode": mode, "eager": {
                k: r.get("eager", r)[k] for k in TRAIN_KEYS}}
            if pairs:
                out["compiled"] = {k: r[k] for k in (
                    *TRAIN_KEYS, "capture_ms", "pool_mib")}
            emit("train", out)
            torch.cuda.empty_cache()
    if "fused" in parts:
        from warp_rnnt_tpu_torch.benchmarks import fused_step

        emit("fused", fused_step.measure())


if __name__ == "__main__":
    main()
