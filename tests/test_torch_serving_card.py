"""The serving path on the card (`cuda`-marked; skipped without a GPU).

The checks live in `warp_rnnt_tpu_torch/benchmarks/serving_cases.py`,
which `chip_smoke.py` runs at full width; here they run at smaller widths.
The card has no flax: the models come from `train_cases.flax_tree`.
  * the restricted loss on the kernel path: against the scan on the card
    (costs rtol 1e-5, gradients 5e-3 of the largest), a huge band equal to
    `rnnt_loss` bit for bit, and infeasible samples +inf with exactly zero
    and finite gradients under 'none', left out of 'sum' and 'mean';
  * the alignment on the card equals the CPU's (frames; scores rtol 1e-5);
  * ``torch.argmax`` ties resolve to the first index on the card, and
    `_top_k_small` gives the CPU's values and indices;
  * chunked streaming equals one-shot decoding on the card, greedy and
    beam (tokens, lengths, scores);
  * the decoders: beam 1 equals greedy, and on an fp32 model each beam
    score is at most its tokens' Viterbi score + 1e-3;
  * a small fp32 model decodes to the CPU's tokens on the card;
  * the decode loop's CUDA graphs (`utils/device_loop.py`) against the
    plain loop run eagerly on the card, bit for bit: greedy and beam, fp32
    and bf16, and chunked sessions at C=16, 7 and 1, with the same trip
    counts and exactly one host read a drain (the while node's); a
    second decode of one shape captures no new graph, nor does one of
    another length that pads to the same width, and flipping TF32
    captures one.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch import rnnt_loss
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.models.beam_search import _top_k_small

pytestmark = pytest.mark.cuda

RESTRICTED_SMALL = dict(N=6, T=40, U=9, V=300)
STREAM_SMALL = dict(N=4, C=16, F=20, H=64, V=64, beam=4, max_length=40, T=96)


@pytest.fixture(scope="module")
def restricted():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return sc.restricted_inputs(0, **RESTRICTED_SMALL)


def test_restricted_on_the_kernel_path(cuda_device, restricted):
    r, launches, launches_ng = sc.check_restricted(*restricted)
    assert sorted(launches) == sorted(sc.RESTRICTED_PATH)
    assert sorted(launches_ng) == sorted(sc.RESTRICTED_NO_GRAD_PATH)
    # the kernel path's raw cost of an infeasible sample is the sentinel
    assert r["infeasible_raw_cost"] > 0.5e30


def test_alignment_card_equals_cpu(cuda_device, restricted):
    costs = rnnt_loss(*restricted[:4])
    sc.check_alignment(*restricted[:4], costs)


def test_argmax_ties_go_to_the_first_index(cuda_device):
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5,
                      [-torch.inf] * 5, [2.0, 1.0, 2.0, 2.0, 2.0]],
                     device=cuda_device)
    assert x.argmax(-1).tolist() == [1, 0, 0, 0]
    big = torch.zeros(64, 4, 1024, device=cuda_device)
    big[..., 700] = 1.0
    big[..., 900] = 1.0
    assert (big.argmax(-1) == 700).all()
    xt = torch.randn(64, 4, 1024, device=cuda_device)
    xt[..., 7] = xt.max(-1).values
    xt[1, :, 5:] = -1e30
    xt[2, :, :] = -torch.inf
    for got, want in zip(_top_k_small(xt, 4), _top_k_small(xt.cpu(), 4)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("chunks", [(16, 7), (1,)])
def test_streaming_equals_one_shot_on_the_card(cuda_device, chunks):
    d = STREAM_SMALL
    model = sc.carried_model(d, 7)
    T = 32 if chunks == (1,) else d["T"]
    feats = sc.features(8, d["N"], T, d["F"])
    xn = sc.ragged(d["N"], T)
    sc.check_streaming(model, feats, xn, d["max_length"], d["beam"], chunks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoders_on_the_card(cuda_device, dtype):
    """Beam 1 equals greedy, tokens in range; on the fp32 model each beam
    score at most its tokens' Viterbi score + 1e-3."""
    d = STREAM_SMALL
    model = sc.carried_model(d, 5, compute_dtype=dtype)
    feats = sc.features(6, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    with sc.no_tf32():
        _, beam_out = sc.check_decoders(model, feats, xn, d["V"], d["beam"],
                                        d["max_length"])
    if dtype == torch.float32:
        sc.beam_score_gaps(model, feats, xn, beam_out, sc.SCORE_ATOL)


def test_card_tokens_equal_cpu_tokens_fp32(cuda_device):
    assert sc.check_card_equals_cpu() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_decoders_equal_plain(cuda_device, dtype):
    d = STREAM_SMALL
    model = sc.carried_model(d, 5, compute_dtype=dtype)
    feats = sc.features(6, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    r = sc.check_graphed(model, feats, xn, d["max_length"], d["beam"])
    assert r["greedy"]["iterations"] >= int(xn.max())
    assert r["beam"]["iterations"] >= int(xn.max())
    assert r["greedy"]["host_reads"] == r["beam"]["host_reads"] == 1


@pytest.mark.parametrize("chunks", [(16, 7), (1,)])
def test_graphed_streaming_equals_plain(cuda_device, chunks):
    d = STREAM_SMALL
    model = sc.carried_model(d, 7)
    T = 32 if chunks == (1,) else d["T"]
    feats = sc.features(8, d["N"], T, d["F"])
    xn = sc.ragged(d["N"], T)
    r = sc.check_graphed_streaming(model, feats, xn, d["max_length"],
                                   d["beam"], chunks)
    for case, counts in r.items():
        C = int(case.rsplit("C=", 1)[1])
        assert counts["host_reads"] == -(-T // C) + 1, case


def test_graph_cache_keys(cuda_device):
    d = STREAM_SMALL
    model = sc.carried_model(d, 5)
    feats = sc.features(6, d["N"], d["T"], d["F"])
    assert sc.check_graph_cache(model, feats, sc.ragged(d["N"], d["T"]),
                                d["max_length"]) == (0, 0, 1)
