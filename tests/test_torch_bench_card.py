"""The benchmark tier on the card (`cuda`-marked; skipped without a GPU).

The checks live in `warp_rnnt_tpu_torch/benchmarks/bench_cases.py`, which
`chip_smoke.py` phase 17 runs at the benchmarks' full widths; here they
run at small ones:
  * `bench_loss` at a small config: a table row's loss+grad and no-grad
    costs on the kernels against the scan (costs rtol 1e-5, gradient 5e-3
    of its largest), and both timers give a positive ms;
  * one row of `run_table` in its child process gives numbers, no error;
  * the lattice kernel on a padded lattice of two waves of blocks against
    the float64 twin;
  * every `bench_joint` mode at N=2: each against "log_softmax+gather"
    (loss rtol 2e-3, gradients 2e-2 of the largest), launching exactly
    its route's kernels; `bench_joint` itself returns its keys;
  * `op_breakdown` of a `trace` of main-path calls lists the lattice,
    `flat_write` and gather kernels;
  * `peak_memory_mb` is at least the arguments' bytes.
"""

import json

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import bench_cases as bc
from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks import run_table as rt
from warp_rnnt_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

JOINT_SMALL = dict(N=2, T=20, U=5, V=300, H=64)


def test_bench_loss_small_config(cuda_device):
    errs, launches = bc.check_table_row(40, 8, 28, N=3)
    assert errs["grad_share"] <= bc.GRAD_TOL
    assert launches["loss_grad"]["gather_lattice"] == 1
    for grad in (True, False):
        ms = bl.run_loss_bench(3, 40, 8, 28, 4, grad=grad)
        assert ms > 0


def test_run_table_one_row(cuda_device, tmp_path):
    doc = rt.main(str(tmp_path / "t.json"), rows=[(150, 40, 28, 1)])
    (row,) = doc["rows"]
    assert "error" not in row, row
    assert row["loss_grad_ms"] > 0 and row["fwd_ms"] > 0
    assert row["bound_ms"] > row["fwd_bound_ms"] > 0
    assert doc["device"] and doc["power_limit"].endswith("W")
    assert json.loads((tmp_path / "t.json").read_text()) == doc


def test_long_lattice_two_waves(cuda_device):
    n = torch.cuda.get_device_properties(0).multi_processor_count + 2
    errs, launches = bc.check_long_lattice(N=n, T=300, U=60, samples=(0, n - 1))
    assert launches == {"lattice_fused": {"lattice_fused": 1},
                        "lattice_beta_only": {"lattice_beta_only": 1}}
    assert max(errs.values()) < 1e-2


@pytest.mark.parametrize("rand_length", [False, True])
def test_bench_joint_modes_agree(cuda_device, rand_length):
    errs, launches, routes = bc.check_joint_modes(**JOINT_SMALL,
                                                  rand_length=rand_length)
    assert set(errs) == set(bj.MODES)
    assert routes["auto"] in ("padded", "fused")
    assert "packed_gather" in launches["compact"]
    assert "fused_joint_fwd" in launches["fused"]


@pytest.mark.parametrize("mode", bj.MODES)
def test_bench_joint_step(cuda_device, mode):
    r = bj.bench_joint(mode=mode, iters=4, **JOINT_SMALL)
    assert r["mode"] == mode and r["step_ms"] > 0 and r["peak_hbm_mb"] > 0
    assert r["kernels_per_call"] > 0 and 0 <= r["idle_share"] <= 1
    assert r["profile_complete"]
    assert r["device"] and r["power_limit"].endswith("W")


def test_op_breakdown_lists_the_main_path_kernels(cuda_device, tmp_path):
    rows = bc.trace_main_path(str(tmp_path), N=4, T=40, U=8, V=300)
    assert not bc.missing_symbols(rows), rows
    times = [us for us, _ in rows]
    assert times == sorted(times, reverse=True)


def test_peak_memory_at_least_the_arguments(cuda_device):
    x = torch.randn(1 << 20, device="cuda")
    mb = profiling.peak_memory_mb(lambda a: a * 2 + 1, x)
    assert mb >= x.numel() * 4 / 2**20
    stats = profiling.device_memory_stats()
    assert stats["bytes_limit"] >= stats["peak_bytes_in_use"] > 0
