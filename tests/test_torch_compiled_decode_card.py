"""The compiled decode and the compiled streaming chunk on the card
(`cuda`-marked; skipped without a GPU).  The checks live in
`warp_rnnt_tpu_torch/benchmarks/compiled_decode_cases.py`, which
`chip_smoke.py` (`phase_compiled_decode`) runs at `bench_decode`'s and
`bench_streaming`'s widths; here they run at small ones:
  * the compiled greedy and beam decodes equal the eager decode and the
    plain loop (`device_loop._plain()`) bit for bit, cond false at entry
    included; a call is one replay and one host read, and the outer graph
    holds exactly one conditional node; its launches, read from its
    graphs and the rounds counted on the card, hold the step's kernels;
  * a compiled session (greedy and beam, a ragged tail) equals the eager
    and the plain sessions after every chunk, one replay and one host
    read a chunk; two interleaved sessions each equal their one-shot
    decode;
  * a compiled loop past its bound raises the eager loop's error after
    its replay, and the next call is right;
  * a loop a compiled decode holds survives `device_loop.clear()` and
    the cache's eviction;
  * a compiled train step's in-place updates reach the next compiled
    decode, which equals an eager decode on the updated weights;
  * the benchmarks' compiled and eager decode readings are positive.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import compiled_decode_cases as cdc
from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

pytestmark = pytest.mark.cuda

D = dict(N=3, F=20, H=64, V=40, max_length=30, T=45)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return sc.carried_model(D, 21)


def _feats(seed):
    return sc.features(seed, D["N"], D["T"], D["F"])


@pytest.mark.parametrize("beam", [0, 4])
def test_compiled_decode_equals_eager_and_plain(cuda_device, model, beam):
    r = cdc.check_decode(model, _feats(22), sc.ragged(D["N"], D["T"]),
                         D["max_length"], beam)
    assert r["steady"]["replays"] == 1 and r["steady"]["host_reads"] == 1
    assert r["kinds"]["conditional"] == 1
    gru = sum(n for k, n in r["launches"].items() if "decode_gru" in k)
    assert r["launches"]["loop_continue_kernel"] == r["rounds"][0] >= 1
    assert gru > r["rounds"][0]  # the first step's, then each round's


@pytest.mark.parametrize("beam", [0, 4])
def test_compiled_chunks_equal_eager_and_plain(cuda_device, model, beam):
    r = cdc.check_chunk(model, _feats(23), sc.ragged(D["N"], D["T"]),
                        D["max_length"], beam, 16)
    assert r["chunks"] == 3 and r["steady"]["host_reads"] == 1
    assert r["launches"]["loop_continue_kernel"] >= 1


@pytest.mark.parametrize("beam", [0, 4])
def test_interleaved_compiled_sessions(cuda_device, model, beam):
    xn = sc.ragged(D["N"], D["T"])
    csc.check_interleaved(model, (_feats(24), _feats(25)), (xn, xn.flip(0)),
                          D["max_length"], beam, 16)


def test_bound_raises_after_the_replay(cuda_device):
    r = cdc.check_bound()
    assert "past its bound of 9" in r["message"]
    assert r["next_call_iterations"] == 9


def test_held_loop_survives_clear_and_eviction(cuda_device, model):
    cdc.check_held(model, _feats(26), sc.ragged(D["N"], D["T"]),
                   D["max_length"])


def test_no_stale_weights_after_a_compiled_train_step(cuda_device):
    assert cdc.check_update(tc.SMALL) > 0


def test_decode_times_are_positive(cuda_device, model):
    r = cdc.decode_times(model, _feats(27), sc.ragged(D["N"], D["T"]),
                         D["max_length"], 0, calls=2)
    assert min(r["compiled"]) > 0 and min(r["eager"]) > 0
    assert len(r["compiled"]) == len(r["eager"]) == 4
