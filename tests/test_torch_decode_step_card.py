"""The decode step's kernels on the card (`cuda`-marked; skipped without a
GPU), against their plain versions (`ops/decode_step.py`), through the
checks of `warp_rnnt_tpu_torch/benchmarks/decode_step_cases.py`, which
`chip_smoke.py` runs at full width:
  * each kernel at odd widths: H=200, V=29, 5, 37, 15 and 111 rows (not a
    multiple of the 32-row tile), add and concat joints, bf16 and fp32;
  * each kernel on the states a small model's plain greedy and beam
    decodes visit, fp32 and bf16;
  * `decode_beam_select` bit for bit against its plain version on the
    hand-built adversarial states (B = 1, 4, 8) and on the states a plain
    beam decode visits; a beam decode and a streaming beam session on the
    kernels equal to the parent's path (the selection plain);
  * the decoders launching the kernels (beam's selection: with the
    adversarial states).
This file imports no JAX (the card's machine runs it).
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
from warp_rnnt_tpu_torch.utils import device_loop

pytestmark = pytest.mark.cuda


def test_odd_widths_kernels_match_plain(cuda_device):
    out = dsc.odd_cases()
    assert len(out) == 2 * 2 * len(dsc.ODD_ROWS)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_recorded_states_kernels_match_plain(cuda_device, cd):
    d = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)
    model = sc.carried_model(d, 5, "cuda", cd)
    feats = sc.features(6, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    with sc.no_tf32():
        recs, _ = dsc.record_states(model, feats, xn, d["max_length"],
                                       d["beam"], every=8)
        out = dsc.check_records(recs)
    assert out["greedy"]["decode_joint"]["calls"] >= 4


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_beam_select_kernel_matches_plain(cuda_device, cd):
    out = dsc.select_cases()
    assert all(r["max_abs_err"] == 0.0 for r in out.values())
    d = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)
    model = sc.carried_model(d, 5, "cuda", cd)
    feats = sc.features(6, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    with sc.no_tf32():
        recs, _ = dsc.record_states(model, feats, xn, d["max_length"],
                                    d["beam"], every=8)
        sel = dsc.check_select_records(recs)
        dsc.check_parent_path(model, feats, xn, d["max_length"], d["beam"],
                              7)
    assert sel["beam"]["calls"] >= 4
    device_loop.clear()
    _, launches = sc.launched(lambda: beam_decode(
        model, feats, xn, d["max_length"], beam_size=d["beam"]))
    assert launches.get("decode_beam_select", 0) > 0


def test_decoders_launch_the_kernels(cuda_device):
    d = dict(N=4, T=40, F=20, H=64, V=64, beam=4, max_length=20)
    model = sc.carried_model(d, 7, "cuda")
    feats = sc.features(8, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    device_loop.clear()
    decoders = {
        "greedy": lambda: greedy_decode(model, feats, xn, d["max_length"]),
        "beam": lambda: beam_decode(model, feats, xn, d["max_length"],
                                    beam_size=d["beam"])}
    for name, fn in decoders.items():
        _, launches = sc.launched(fn)
        assert launches.get("decode_joint", 0) > 0, name
        assert launches.get("decode_gru", 0) > 0, name
