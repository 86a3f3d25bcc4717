"""Shared fixtures of the benchmark's tests: the checkout's root on the
path, tiny CPU forms of each cell, and the card where a test needs one
(decided here, inside a fixture, never when a module is imported)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs its CUDA kernels")
    return torch.cuda.get_device_name(0)


def _load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@pytest.fixture
def tiny_loss():
    """(workload, config, mix) of the long loss cell at a CPU size."""
    mix = _load("portbench/traffic/t1500.u300.v50.n128.json")
    mix.update(N=4, T=12, U=6, V=7, frames=[6, 12], labels=[3, 5])
    return ("loss.1500x300x50.n128",
            _load("portbench/configs/rnnt-loss-fp32.json"), mix)


@pytest.fixture
def tiny_train():
    """(workload, config, mix) of the train cell at a CPU size."""
    mix = _load("portbench/traffic/n32.t400.u40.json")
    mix.update(N=4, T=12, U=6, V=16, feat_dim=8, frames=[6, 12],
               labels=[3, 5])
    cfg = _load("portbench/configs/transducer-h512-v1024.json")
    cfg.update(vocab=16, feat_dim=8, hidden=16, joint=12)
    return "train.h512v1024.n32", cfg, mix


@pytest.fixture
def tiny_decode():
    """(workload, config, mix) of the decode cell at a CPU size."""
    mix = _load("portbench/traffic/n32.buckets.json")
    mix.update(N=4, feat_dim=8, buckets=[[12, 2], [24, 1]])
    cfg = _load("portbench/configs/transducer-h512-v1024.json")
    cfg.update(vocab=64, feat_dim=8, hidden=16, joint=12, max_length=12)
    return "decode.beam4.n32", cfg, mix
