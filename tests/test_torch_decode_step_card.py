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
    adversarial states);
  * each kernel at a wide model's widths (hidden 1024, V=5000, 16 and 64
    rows) and at widths whose K shares take a ring of stages, against
    the plain versions under the same tolerances; two calls of each
    kernel bit for bit (the clusters' sums in a fixed order);
  * the step captured in a CUDA graph with programmatic edges between
    its launches, and greedy and beam decodes through the graphs equal
    to the eager loop bit for bit;
  * the loop's mask and count folded in: `decode_gru_greedy` and
    `decode_beam_select` folded, with the loop's cond true and false,
    against their folded plain versions (the integers, last_tok, the
    count and the selection bit for bit) on the recorded states, at odd,
    wide and ring widths and on the adversarial selection states; the
    folded greedy, beam and streaming drains through the graphs equal to
    the unfolded drains on the same kernels, eager and graphed, bit for
    bit; two captured folded steps joined by a programmatic edge from
    the GRU to the next step's hidden layer.
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


def test_wide_and_ring_widths_kernels_match_plain(cuda_device):
    out = dsc.wide_cases()
    for name, rows_list in (("wide", dsc.WIDE_ROWS), ("ring", dsc.RING_ROWS)):
        cases = {k: v for k, v in out[name].items() if k != "plans"}
        assert len(cases) == 2 * 2 * len(rows_list)
    ring = out["ring"]["plans"]
    assert all(p["hidden"]["stages"] > 1 and p["gru"]["stages"] > 1
               for p in ring.values())


def test_kernels_deterministic(cuda_device):
    runs = sum(2 if k is not None else 3 for _, _, k in dsc.WIDE_ROWS)
    assert dsc.check_deterministic() == 2 * 2 * runs
    assert dsc.check_deterministic(dims=dsc.RING, rows_list=dsc.RING_ROWS) > 0


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_graphed_step_has_programmatic_edges_and_equals_eager(cuda_device,
                                                              cd):
    joint, _, greedy = dsc.odd_args(3, 32, 32, None, cd)
    programmatic, edges = dsc.pdl_edges(joint, greedy)
    assert programmatic >= 1 and edges >= programmatic
    d = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)
    model = sc.carried_model(d, 9, "cuda", cd)
    feats = sc.features(10, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    with sc.no_tf32():
        loops = sc.check_graphed(model, feats, xn, d["max_length"], d["beam"])
    assert set(loops) == {"greedy", "beam"}


SMALL = dict(N=4, T=96, F=20, H=64, V=64, beam=4, max_length=40)


def _small(cd, seed=5):
    model = sc.carried_model(SMALL, seed, "cuda", cd)
    feats = sc.features(seed + 1, SMALL["N"], SMALL["T"], SMALL["F"])
    return model, feats, sc.ragged(SMALL["N"], SMALL["T"])


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_folded_kernels_match_plain_on_recorded_states(cuda_device, cd):
    model, feats, xn = _small(cd)
    with sc.no_tf32():
        recs, _ = dsc.record_states(model, feats, xn, SMALL["max_length"],
                                    SMALL["beam"], every=8)
        out = dsc.check_fold_records(recs)
    assert out["greedy"]["decode_gru_greedy"]["calls"] >= 8
    assert out["beam"]["decode_beam_select"]["calls"] >= 8
    assert out["beam"]["decode_beam_select"]["max_abs_err"] == 0.0


def test_folded_kernels_match_plain_at_odd_wide_and_ring_widths(cuda_device):
    cases = [c for c in dsc.odd_cases(seed=11).values()]
    wide = dsc.wide_cases(seed=12)
    for name in ("wide", "ring"):
        cases += [c for k, c in wide[name].items() if k != "plans"]
    folded = [c[k] for c in cases for k in c if "folded" in k]
    assert len(folded) == 2 * sum(1 for c in cases if "decode_gru_greedy" in c)
    assert all(r["max_abs_err"] <= dsc.GRU_TOL for r in folded)


def test_folded_select_matches_plain_on_adversarial_states(cuda_device):
    out = dsc.select_fold_cases(seed=13)
    assert len(out) == 2 * len(dsc.SELECT_BEAMS)
    assert all(r["max_abs_err"] == 0.0 for r in out.values())


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_folded_drains_equal_unfolded(cuda_device, cd):
    model, feats, xn = _small(cd, 9)
    with sc.no_tf32():
        out = dsc.check_fold(model, feats, xn, SMALL["max_length"],
                             SMALL["beam"], 16)
    assert len(out) == 4 and all(r["iterations"] > 0 for r in out.values())


def test_folded_step_gru_to_next_hidden_is_programmatic(cuda_device):
    from warp_rnnt_tpu_torch.ops import decode_step as ds

    model, feats, xn = _small(torch.bfloat16)
    with sc.no_tf32():
        recs, _ = dsc.record_states(model, feats, xn, SMALL["max_length"],
                                    SMALL["beam"], every=8)
        out = dsc.step_edges(recs)
    for r in out.values():
        assert r["two"][1] == 2 * r["one"][1] + 1
        assert r["gru_to_hidden"] or not ds.pdl_built()
