"""The device loop's while node on the card (`cuda`-marked; skipped
without a GPU): `utils/device_loop.py` over `csrc/device_loop.cu`, through
the checks of `warp_rnnt_tpu_torch/benchmarks/device_loop_cases.py`, which
`chip_smoke.py` runs at full width:
  * toy loops (ragged trip counts, all equal, none, one sample far past
    the rest) through one while launch equal the eager loop on the card
    bit for bit, with JAX's trip count and one host read, at unroll 1, 4
    and 16;
  * a loop whose cond is false at entry leaves the state bit for bit,
    count 0;
  * a loop past its bound raises the eager loop's RuntimeError after one
    launch, in a child process with its own timeout (a loop that did not
    stop on the device would hang it, not the tests);
  * ``loop_continue_kernel`` against the eager loop's stop rule on a
    probe that counts every step it runs (bounds above, at and below the
    trip count);
  * greedy, beam 4 and streaming sessions at C=16 on the step's kernels:
    the while node equals the plain loop (`device_loop._plain`) bit for
    bit on the whole state, the same trip counts, one host read and one
    launch a drain;
  * a drain's body holds only node kinds a conditional body takes, and
    its round keeps the captured round's edges, programmatic ones among
    them.
This file imports no JAX (the card's machine runs it).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop

pytestmark = pytest.mark.cuda

SMALL = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_TIMEOUT_S = 300  # the child process's, the build included


@pytest.mark.parametrize("unroll", dlc.UNROLLS)
@pytest.mark.parametrize("case", sorted(dlc.LIMITS))
def test_toy_loop_equals_eager(cuda_device, case, unroll):
    r = dlc.check_toy(case, unroll)
    assert r["iterations"] == max(dlc.LIMITS[case])
    assert r["host_reads"] == 1


def test_cond_false_at_entry_leaves_the_state(cuda_device):
    r = dlc.check_false_at_entry()
    assert r["iterations"] == 0 and r["host_reads"] == 1


def test_loop_past_its_bound_raises_without_hanging(cuda_device):
    code = ("import json, torch; from warp_rnnt_tpu_torch.benchmarks import"
            " device_loop_cases as d; print(json.dumps(d.check_bound()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=BOUND_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    msgs = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(msgs) == {"1", "4"}
    assert all("past its bound of 9" in m[0] for m in msgs.values())


def test_loop_continue_kernel_matches_the_stop_rule(cuda_device):
    r = dlc.check_continue()
    loops = len(dlc.UNROLLS) * len(dlc.PROBE_TRIPS)
    assert r["max_abs_err"] == 0.0
    assert r["cases"] == loops * len(dlc.PROBE_BOUNDS)
    assert r["launches"] == r["cases"] + loops  # each loop's first call


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_drains_equal_plain_with_one_read(cuda_device, cd):
    model = sc.carried_model(SMALL, 11, "cuda", cd)
    feats = sc.features(12, SMALL["N"], SMALL["T"], SMALL["F"])
    xn = sc.ragged(SMALL["N"], SMALL["T"])
    with sc.no_tf32():
        r = dlc.check_drains(model, feats, xn, SMALL["max_length"],
                             SMALL["beam"], 16)
    assert len(r) == 4
    assert all(v["host_reads"] == v["drains"] for v in r.values())
    assert r["stream greedy C=16"]["drains"] == 96 // 16 + 1


def test_body_kinds_and_edges(cuda_device):
    model = sc.carried_model(SMALL, 13, "cuda")
    feats = sc.features(14, SMALL["N"], SMALL["T"], SMALL["F"])
    xn = sc.ragged(SMALL["N"], SMALL["T"])
    device_loop.clear()
    with sc.no_tf32():
        greedy_decode(model, feats, xn, SMALL["max_length"])
        beam_decode(model, feats, xn, SMALL["max_length"],
                    beam_size=SMALL["beam"])
    for name in ("greedy", "beam"):
        r = dlc.body_report(name)
        assert set(r["kinds"]) <= device_loop.BODY_KINDS
        assert r["kinds"]["kernel"] > 0
        if ds.pdl_built():
            assert r["edges"][0] >= 1
