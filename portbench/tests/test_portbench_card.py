"""Each cell run briefly on the card, as the driver runs it: one line
last on standard output, correct, from the card it names."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace, card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          workload, "--seed", str(2**31 + 101), "--seconds",
                          "2", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == card
    assert line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
