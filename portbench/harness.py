"""One run of one cell: set-up, the measured window, the check, the line.

`BENCHMARK.json` names each cell's configuration (`configs/<config>.json`:
the sizes of what is run) and traffic mix (`traffic/<traffic>.json`: what
is asked of it).  The mix names its ``entry``, the module under
`entries/` that drives the program with it; every metric is a reader,
`metrics/<name>.py`.
So a cell, a configuration, a mix or a metric is added by adding files
and entries, never by editing this module.

An entry module defines ``Cell(config, mix, seed, device, wrap=None)``
(``wrap``, where given, wraps the program's call as soon as it is built:
the control and the planted faults) with
``setup()`` (inputs, program, warm-up of every shape the window uses),
``call(i)`` (the i-th timed call), ``finish()`` (wait for the device),
``units`` (utterances a call completes), ``context()`` (host numbers the
readers need: shapes, valid cells, calls) and ``check()`` (after the
window: ``({name: (value, limit)}, failed answers)``, each value compared
with the plain reference and held to ``value <= limit``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")
# whole top-level module names that no run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "warp_rnnt_tpu")


class NoResult(Exception):
    """A run that must end without a result line (its message says why)."""


def cache_env(environ=os.environ):
    """Every build and kernel cache at a fixed path inside the checkout,
    Python's bytecode among them: where the environment asks for none to
    be written, every run would compile the source of every module it
    imports (seconds of torch's import), so this process writes and reads
    it under the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("PYTHONPYCACHEPREFIX", "pycache")):
        environ[var] = os.path.join(CACHE, sub)
    environ["USE_FLAX"] = "0"
    sys.pycache_prefix = environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    if spec is None:
        raise NoResult(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """(workload entry, configuration entry) of the cell ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return w, configs[w["config"]]


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def mix_file(w: dict) -> str:
    """The traffic file of the workload entry ``w``, from the root."""
    return os.path.join("portbench", "traffic", f"{w['traffic']}.json")


def metrics_for(bench: dict, kind: str, workload: str) -> list:
    """The entries of ``bench[kind]`` that the cell ``workload`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """The ``read(ctx)`` of `metrics/<name>.py`."""
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   f"portbench_metric_{name}").read


def entry_module(name: str):
    """`entries/<name>.py`: its ``Cell``, its ``control(config)`` and its
    ``FAULTS``."""
    return _module(os.path.join(HERE, "entries", f"{name}.py"),
                   f"portbench_entry_{name}")


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among the loaded modules, each
    module's name compared whole up to its first dot."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, *, device: str = "cuda", bench=None,
             config=None, mix=None, program=None) -> dict:
    """One run; returns the result line as a dict.  ``device``, ``bench``,
    ``config``, ``mix`` and ``program`` (a wrapper of the entry's program call,
    ``program(call) -> call``) replace what the checkout holds,
    for the tests on the CPU and the readings of the control."""
    t_import = time.time()
    import torch

    from portbench import peaks

    phases = {"start to import": t_import - t_start,
              "import torch": time.time() - t_import}
    bench = bench if bench is not None else benchmark()
    w, cfg_entry = cell_spec(bench, workload)
    chips = int(w["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the"
                           f" cell asks for {chips}")
        t_card = time.time()
        torch.cuda.init()
        torch.empty(1, device=device)  # the context
        phases["card start"] = time.time() - t_card
    config = config if config is not None else load_json(cfg_entry["file"])
    mix = mix if mix is not None else load_json(mix_file(w))
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))

    cell = entry_module(mix["entry"]).Cell(config, mix, seed, device,
                                              wrap=program)
    t_setup = time.time()
    cell.setup()
    phases.update({"set-up": time.time() - t_setup},
                  **getattr(cell, "phases", {}))
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if trace and on_card:
        from portbench.trace import Tracer

        tracer = Tracer()
        tracer.__enter__()
    cell.traced = tracer is not None
    latencies = []
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    calls = 0
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        cell.call(calls)
        latencies.append(time.perf_counter() - ts)
        calls += 1
    cell.finish()
    window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
    # reserved, not allocated: a compiled step's tensors live in its CUDA
    # graph's private pool, which the allocator counts as reserved only
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise NoResult("modules loaded that the program may not load: "
                       + ", ".join(bad))

    checks, failed = cell.check()
    correct = failed == 0 and all(_finite(v) and v <= lim
                                  for v, lim in checks.values())
    ctx = {"window_s": window_s, "calls": calls, "units": calls * cell.units,
           "latencies_s": latencies, "setup_s": setup_s, "peak_bytes": peak,
           "cell": cell.context(), "trace": tracer,
           "rates": peaks.card_rates(torch.cuda.get_device_name(0)
                                     if on_card else "")}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, kind, workload):
        value = reader(m["name"])(ctx)
        if value is None and kind == "end_to_end":
            raise NoResult(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": calls, "failed": failed,
            "metrics": metrics, "device": dev}
    if tracer is not None:
        from portbench import trace as tr

        busy = tr.busy_ns(tracer.device) / 1e9
        dev.update(busy_s=busy, window_s=window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(tracer.device),
                             "idle_gaps": tr.idle_gaps(tracer.device,
                                                       tracer.host)}
    line["setup_phases_s"] = phases
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    return line


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json"
                                 " once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start)
    except NoResult as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    print("set-up phases (s): " + json.dumps(line.pop("setup_phases_s")),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
