"""The port's examples run on the CPU at a few steps
(`python -m warp_rnnt_tpu_torch.examples.train_toy` and
`...streaming_demo`, each with ``--device cpu``): they train, decode,
align, and stream to the one-shot decode exactly.  ``train_toy
--data-parallel`` spawns 2 gloo ranks (120 s, as every spawning test) and
trains to the single-process losses."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=300):
    r = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _losses(out):
    return [float(line.split()[-1]) for line in out.splitlines()
            if line.startswith("step")]


def test_train_toy_trains_decodes_and_aligns():
    out = _run("warp_rnnt_tpu_torch.examples.train_toy", "--steps", "3")
    losses = _losses(out)
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert "greedy decode:" in out and "beam-4 decode:" in out
    assert "forced alignment of sample 0" in out


def test_train_toy_data_parallel_matches_one_process():
    """Two ranks, each with half the batch: step 0's loss equals one
    process's to rtol 1e-5 (the mean of equal shards' means is the batch
    mean); the last within 1e-3, since Adam's steps amplify the rounding of
    gradients near its eps (`train_cases.compare_steps`).  Then rank 0
    alone decodes and aligns."""
    out = _run("warp_rnnt_tpu_torch.examples.train_toy", "--steps", "3",
               "--data-parallel", "--ranks", "2", timeout=120)
    assert "data-parallel over 2 ranks (cpu)" in out
    single = _losses(_run("warp_rnnt_tpu_torch.examples.train_toy", "--steps",
                          "3"))
    got = _losses(out)
    assert len(got) == 2 and got[0] == pytest.approx(single[0], rel=1e-5)
    assert got[1] == pytest.approx(single[1], rel=1e-3) and got[1] < got[0]
    assert out.count("greedy decode:") == 1 and "beam-4 decode:" in out
    assert "forced alignment of sample 0" in out


@pytest.mark.parametrize("beam", ["0", "3"])
def test_streaming_demo_is_exact(beam):
    out = _run("warp_rnnt_tpu_torch.examples.streaming_demo", "--chunk", "7",
               "--beam", beam)
    assert "== one-shot decode: EXACT" in out
