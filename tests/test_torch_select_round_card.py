"""Beam's selection as one warp a sample and the device loop's round ended
by one launch, on the card (`cuda`-marked; skipped without a GPU), through
`warp_rnnt_tpu_torch/benchmarks/decode_step_cases.py`,
`device_loop_cases.py` and `compiled_decode_cases.py`, which
`chip_smoke.py` runs at full width:
  * `decode_beam_select` against its plain version bit for bit at every
    (B, K) of `SELECT_WIDTHS` (each candidate route of `select_plan`, up
    to 64 x 65 candidates) at an odd L, unfolded and folded with the
    loop's cond true and false, the ``into=`` route too; on the
    adversarial states and on the states a plain beam decode visits; two
    calls bit for bit; a captured beam step's edges all programmatic
    (joint, selection, GRU);
  * the folded toy whose cond the card takes (`device_loop.AnyLess`)
    against the eager loop at unroll 1, 4 and 16 (no copy in the round
    past unroll 1), and past its bound (a child process with its own
    timeout);
  * greedy, beam and streaming drains against the plain loop at unroll 1,
    4 and 16, and each decoder's round: one launch after its last step
    (``loop_continue_kernel``) at unroll 16, its copies at unroll 1;
  * the compiled decodes and interleaved compiled sessions against the
    eager and plain ones at unroll 1 and 4, and a compiled loop on the
    card's cond past its bound.
This file imports no JAX (the card's machine runs it).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import compiled_decode_cases as cdc
from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop

pytestmark = pytest.mark.cuda

SMALL = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_TIMEOUT_S = 300  # the child process's, the build included


def _inputs(seed):
    model = sc.carried_model(SMALL, seed, "cuda")
    feats = sc.features(seed + 1, SMALL["N"], SMALL["T"], SMALL["F"])
    return model, feats, sc.ragged(SMALL["N"], SMALL["T"])


def test_select_matches_plain_at_every_width(cuda_device):
    r = dsc.select_width_cases(3)
    assert len(r) == 3 * len(dsc.SELECT_WIDTHS)
    assert all(v["max_abs_err"] == 0.0 for v in r.values())
    assert {v["slots"] for v in r.values()} == {0, 1, 2, 4}


def test_select_matches_plain_on_adversarial_states(cuda_device):
    for r in (dsc.select_cases(5), dsc.select_fold_cases(6)):
        assert all(v["max_abs_err"] == 0.0 for v in r.values())


def test_select_two_calls_bit_for_bit(cuda_device):
    assert dsc.check_select_twice(7) == len(dsc.SELECT_WIDTHS)


def test_select_on_recorded_states_and_beam_edges(cuda_device):
    model, feats, xn = _inputs(8)
    with sc.no_tf32():
        recs, _ = dsc.record_states(model, feats, xn, SMALL["max_length"],
                                    SMALL["beam"], every=4)
        r = dsc.check_select_records(recs)
        assert r["beam"]["calls"] >= 2
        folded = dsc.check_fold_records(recs)
        assert folded["beam"]["decode_beam_select"]["max_abs_err"] == 0.0
        if ds.pdl_built():
            programmatic, edges = dsc.step_edges(recs)["beam"]["one"]
            assert programmatic == edges >= 4


@pytest.mark.parametrize("unroll", dlc.UNROLLS)
@pytest.mark.parametrize("case", sorted(dlc.LIMITS))
def test_frames_toy_equals_eager(cuda_device, case, unroll):
    r = dlc.check_frames_toy(case, unroll)
    assert r["iterations"] == max(dlc.LIMITS[case]) and r["host_reads"] == 1
    assert unroll == 1 or r["copies"] == 0


def test_frames_toy_past_its_bound_raises(cuda_device):
    code = ("import json, torch; from warp_rnnt_tpu_torch.benchmarks import"
            " device_loop_cases as d;"
            " print(json.dumps(d.check_bound(frames=True)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=BOUND_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    msgs = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(msgs) == {"1", "4"}
    assert all("past its bound of 9" in m[0] for m in msgs.values())


def test_drains_equal_plain_at_each_unroll(cuda_device):
    model, feats, xn = _inputs(9)
    with sc.no_tf32():
        r = dlc.check_drains(model, feats, xn, SMALL["max_length"],
                             SMALL["beam"], 16, unrolls=(1, 4, 16))
    assert len(r) == 12
    assert all(v["host_reads"] == v["drains"] for v in r.values())


def test_round_ends_in_one_launch(cuda_device):
    model, feats, xn = _inputs(10)
    device_loop.clear()
    for unroll in (1, 16):
        with sc.no_tf32(), device_loop.unrolled(unroll):
            greedy_decode(model, feats, xn, SMALL["max_length"])
            beam_decode(model, feats, xn, SMALL["max_length"],
                        beam_size=SMALL["beam"])
        for name in ("greedy", "beam"):
            r = dlc.round_report(name)
            assert r["card_cond"] and r["unroll"] == unroll
            assert r["other_kernels"] == {}
            if unroll > 1:
                assert r["tail_launches"] == 1 and r["copies"] == 0
            else:
                assert r["copies"] >= 1


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("beam", [0, 4])
def test_compiled_decodes_and_sessions_at_unroll(cuda_device, beam, unroll):
    model, feats, xn = _inputs(11)
    other = sc.features(13, SMALL["N"], SMALL["T"], SMALL["F"])
    with sc.no_tf32(), device_loop.unrolled(unroll):
        r = cdc.check_decode(model, feats, xn, SMALL["max_length"], beam)
        assert r["steady"]["host_reads"] == 1
        cdc.check_chunk(model, feats, xn, SMALL["max_length"], beam, 16)
        csc.check_interleaved(model, (feats, other), (xn, xn.flip(0)),
                              SMALL["max_length"], beam, 16)


@pytest.mark.parametrize("unroll", [1, 4, 16])
def test_compiled_card_cond_bound_raises_after_the_replay(cuda_device,
                                                          unroll):
    with device_loop.unrolled(unroll):
        r = cdc.check_bound(frames=True)
    assert "past its bound of 9" in r["message"]
