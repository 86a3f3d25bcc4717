"""The compiled streaming chunk and joint step on the card (`cuda`-marked;
skipped without a GPU).  The checks live in
`warp_rnnt_tpu_torch/benchmarks/compiled_serving_cases.py`, which
`chip_smoke.py` (`phase_compiled_serving`) runs at `bench_streaming`'s and
`bench_joint`'s widths; here they run at small ones:
  * a session whose encoder step replays its CUDA graph equals the same
    session run eagerly, bit for bit, after every chunk and at the finish
    (greedy and beam, with and without ``xn``, a ragged tail), one replay
    a chunk;
  * two interleaved sessions of one shape each equal their one-shot
    decode;
  * `bench_joint`'s step compiled equals the eager step bit for bit in
    the four modes that compile, full and random lengths, on the
    capture's inputs and on new ones; a replay launches an eager call's
    kernels;
  * a capture that meets a host read (the compact mode) raises, leaves no
    graph, and the card still works;
  * the benchmarks' compiled and eager readings give positive ms.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.benchmarks import bench_streaming as bs
from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc

pytestmark = pytest.mark.cuda

STREAM = dict(N=3, F=20, H=64, V=40, max_length=30, T=45)
JOINT = dict(N=3, T=20, U=5, V=300, H=64)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return sc.carried_model(STREAM, 11)


def _feats(seed):
    return sc.features(seed, STREAM["N"], STREAM["T"], STREAM["F"])


@pytest.mark.parametrize("with_xn", [False, True])
@pytest.mark.parametrize("beam", [0, 4])
def test_compiled_chunks_equal_eager(cuda_device, model, beam, with_xn):
    xn = sc.ragged(STREAM["N"], STREAM["T"]) if with_xn else None
    r = csc.check_stream_compiled(model, _feats(12), xn,
                                  STREAM["max_length"], beam, 16)
    assert r["encoder_replays"] == [1] * r["chunks"]


@pytest.mark.parametrize("beam", [0, 4])
def test_interleaved_sessions_on_the_card(cuda_device, model, beam):
    xn = sc.ragged(STREAM["N"], STREAM["T"])
    csc.check_interleaved(model, (_feats(13), _feats(14)), (xn, xn.flip(0)),
                          STREAM["max_length"], beam, 16)


@pytest.mark.parametrize("rand_length", [False, True])
@pytest.mark.parametrize("mode", csc.JOINT_MODES)
def test_compiled_joint_step_equals_eager(cuda_device, mode, rand_length):
    case = csc.joint_case(**JOINT, rand_length=rand_length, seed=3)
    r = csc.check_joint(mode, *case, profile=not rand_length)
    assert r["capture_ms"] > 0 and r["pool_mib"] >= 0
    if not rand_length:
        assert r["kernels"]["compiled"] == r["kernels"]["eager"]


def test_host_read_fails_the_capture(cuda_device):
    case = csc.joint_case(**JOINT, rand_length=True, seed=4)
    assert "host" in csc.check_host_read_raises(*case)
    assert csc.check_joint("fused", *case) is not None  # the card still works


def test_serving_benchmarks_compiled_and_eager(cuda_device, model):
    for eager in (False, True):
        r = bs.bench_streaming(N=STREAM["N"], C=8, V=STREAM["V"],
                               feat_dim=STREAM["F"], hidden=STREAM["H"],
                               max_length=STREAM["max_length"], model=model,
                               eager=eager)
        assert r["chunk_ms"] > 0 and r["compiled"] is not eager
        assert r["graph_replays_per_chunk"]["encoder"] == (0 if eager else 1)
    for compiled in (True, False):
        r = bj.bench_joint(**JOINT, mode="fused", compiled=compiled, iters=4)
        assert r["step_ms"] > 0 and r["compiled"] is compiled
    r = bj.bench_joint(**JOINT, mode="compact", iters=4)
    assert r["compiled"] is False and "host" in r["not_compiled_reason"]
