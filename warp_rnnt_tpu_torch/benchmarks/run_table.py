"""warp-rnnt's README benchmark table on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/run_table.py`).

    python -m warp_rnnt_tpu_torch.benchmarks.run_table [out.json]

`REFERENCE_GATHER_MS` is warp-rnnt's own published column (gather=True,
ms a batch, on an RTX 2070 Super), copied from the JAX module; None where
its README has no number.  Every (config, N) row runs `run_one` in a child
process of its own, one after the other, so that one row's allocator
state and peak memory stay out of the next.  A child prints
``RESULT {"loss_grad_ms", "fwd_ms", "peak_mb", "bound_ms",
"fwd_bound_ms"[, "layout"]}``: `bench_loss.run_loss_bench`'s loss+grad
and no-grad ms, the most device memory the row allocated, and the least
time the card could take, the bytes the call must move over the memory
rate (`timing.card_rates`): the blank and label log-prob of every
lattice cell read, and with the gradient the dense gradient written once.

`main` writes ``{"device", "power_limit", "torch", "rows"}`` to its
results file (default: `results_h100.json` beside this module).  A row
whose child fails keeps an ``error`` instead of numbers: "OOM" for
`torch.cuda.OutOfMemoryError`, "timeout (Ns)", or the child's last line
on stderr ("bench_loss needs a CUDA device" on a machine without one).
Nothing else stands in for a failed row.  The JAX module's cooldowns and
its non-donated third attempt answer failures of a remote TPU runtime and
are not ported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REFERENCE_GATHER_MS = {
    (150, 40, 28): {1: 0.54, 16: 1.72, 32: 2.94, 64: 5.54, 128: 10.74},
    (150, 20, 5000): {1: 0.80, 16: 6.24, 32: 12.35, 64: None, 128: None},
    (1500, 300, 50): {1: 4.99, 16: 78.88, 32: 157.86, 64: None, 128: None},
}
BATCHES = (1, 16, 32, 64, 128)
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results_h100.json")
CHILD_TIMEOUT_S = 300
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def table_rows():
    """(T, U, V, N) of every row, in the table's order."""
    return [(T, U, V, N) for (T, U, V) in REFERENCE_GATHER_MS for N in BATCHES]


def iters_for(T, U):
    """The JAX module's iteration counts: 30, or 10 on the long lattice."""
    return 30 if T * U <= 10000 else 10


def row_bounds_ms(N, T, U, V, rates):
    """(loss+grad, no-grad) bound ms: the blank and label log-prob of every
    (N, T, U+1) cell read (8 bytes), and for loss+grad the fp32 dense
    gradient written once, over the memory rate ``rates[0]``."""
    cells = N * T * (U + 1)
    return ((cells * 8 + cells * V * 4) / rates[0] * 1e3,
            cells * 8 / rates[0] * 1e3)


def run_one(N, T, U, V, iters, flat=False):
    """One row, in the child: prints ``RESULT {...}``."""
    import torch

    from warp_rnnt_tpu_torch.benchmarks import timing
    from warp_rnnt_tpu_torch.benchmarks.bench_loss import run_loss_bench

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"loss_grad_ms": run_loss_bench(N, T, U, V, iters, grad=True,
                                          flat=flat)}
    torch.cuda.empty_cache()
    out["fwd_ms"] = run_loss_bench(N, T, U, V, iters, grad=False, flat=flat)
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    out["bound_ms"], out["fwd_bound_ms"] = row_bounds_ms(
        N, T, U, V, timing.card_rates())
    if flat:
        out["layout"] = "flat3d"
    print("RESULT " + json.dumps(out), flush=True)


def _child(N, T, U, V, iters):
    """The row's numbers, or {"error": ...}."""
    code = ("from warp_rnnt_tpu_torch.benchmarks.run_table import run_one;"
            f"run_one({N}, {T}, {U}, {V}, {iters})")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                              capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout ({CHILD_TIMEOUT_S}s)"}
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    if "OutOfMemoryError" in proc.stderr:
        return {"error": "OOM"}
    err = proc.stderr.strip().splitlines()
    return {"error": err[-1][:200] if err else f"exit={proc.returncode}"}


def _card():
    import torch

    if not torch.cuda.is_available():
        return {"device": None, "power_limit": None}
    from warp_rnnt_tpu_torch.utils.profiling import card

    return card()


def main(out_path=DEFAULT_OUT, rows=None):
    """Run ``rows`` ((T, U, V, N) tuples; default every row of the table),
    one child each, print each row's JSON line, write the results file and
    return its contents."""
    import torch

    results = []
    for T, U, V, N in rows or table_rows():
        row = {"T": T, "U": U, "V": V, "N": N,
               "ref_gather_ms": REFERENCE_GATHER_MS[T, U, V][N]}
        row.update(_child(N, T, U, V, iters_for(T, U)))
        results.append(row)
        print(json.dumps(row), flush=True)
    doc = {**_card(), "torch": torch.__version__, "rows": results}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


if __name__ == "__main__":
    main(*sys.argv[1:])
