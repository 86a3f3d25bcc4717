"""The port's examples run on the CPU at a few steps
(`python -m warp_rnnt_tpu_torch.examples.train_toy` and
`...streaming_demo`, each with ``--device cpu``): they train, decode,
align, and stream to the one-shot decode exactly."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    r = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_train_toy_trains_decodes_and_aligns():
    out = _run("warp_rnnt_tpu_torch.examples.train_toy", "--steps", "3")
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert "greedy decode:" in out and "beam-4 decode:" in out
    assert "forced alignment of sample 0" in out


@pytest.mark.parametrize("beam", ["0", "3"])
def test_streaming_demo_is_exact(beam):
    out = _run("warp_rnnt_tpu_torch.examples.streaming_demo", "--chunk", "7",
               "--beam", beam)
    assert "== one-shot decode: EXACT" in out
