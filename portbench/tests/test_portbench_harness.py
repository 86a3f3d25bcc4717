"""The harness's contract with its driver: the file it reads, the files
each name in it leads to, the refusal without a card, and that nothing a
run loads is JAX or the JAX package (names compared whole up to the
first dot: the port's name begins with the JAX package's)."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return harness.benchmark()


def test_benchmark_names_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        mix = harness.load_json(harness.mix_file(w))
        assert os.path.exists(os.path.join(
            harness.HERE, "entries", f"{mix['entry']}.py"))
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
        assert all(x in names for x in m.get("workloads", ()))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for x in m.get("workloads", names):
            owner = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert x in owner.get("workloads", names)
    for w in names:  # every cell: setup_s, another end-to-end, a per-layer
        assert len(harness.metrics_for(b, "end_to_end", w)) >= 2
        assert harness.metrics_for(b, "per_layer", w)


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["warp_rnnt_tpu_torch",
                                      "warp_rnnt_tpu_torch.ops",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["warp_rnnt_tpu.models", "jax._src",
                                      "flax"]) == ["flax", "jax",
                                                   "warp_rnnt_tpu"]


_PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
for name in ("loss", "train", "beam_decode"):
    harness.entry_module(name)
b = harness.benchmark()
for m in b["end_to_end"] + b["per_layer"]:
    harness.reader(m["name"])
from portbench import calibrate, trace
w, c = harness.cell_spec(b, "loss.1500x300x50.n128")
mix = harness.load_json(harness.mix_file(w))
mix.update(N=2, T=6, U=3, V=5, frames=[3, 6], labels=[1, 2])
line = harness.run_cell(w["name"], 1, 0.1, False, time.time(),
                        device="cpu", mix=mix)
import warp_rnnt_tpu_torch.models.beam_search, warp_rnnt_tpu_torch.models.transducer
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_nothing_loads_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "warp_rnnt_tpu_torch" in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "loss.150x20x5000.n128", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_run_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "no.such.cell", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
