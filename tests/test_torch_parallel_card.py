"""The parallel tier on the card (`cuda`-marked; skipped without a GPU).

The checks live in `warp_rnnt_tpu_torch/benchmarks/parallel_cases.py`,
which `chip_smoke.py` phase 16 runs at full width; here at smaller widths.
  * the vocabulary-shard kernels (the gather and the dense write with a
    column offset) against their plain twins, exactly, on each half of a
    split vocabulary (blank in the first block, in the second, on its
    first column; labels on both sides of the boundary; fp32 and bf16),
    the halves summing to the whole gather and writing the whole gradient;
  * a 1-rank NCCL world on the card: `rnnt_loss_sharded` and
    `rnnt_loss_shard_map` bit-equal to `rnnt_loss` (costs and gradient),
    through the gather, lattice and write kernels;
  * the sharded train step on a 1x1 ('data', 'model') mesh against the
    single-process step at `train_cases.SMALL`, in each loss mode, and the
    vocabulary-parallel route, which that step does not take, called on
    its own over NCCL against the same gradients.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import parallel_cases as pc
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

pytestmark = pytest.mark.cuda

SMALL_MAIN = dict(N=6, T=40, U=9, V=300)


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """A 1-rank NCCL process group on cuda:0, torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    import torch.distributed as dist

    path = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{path}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", list(pc.SHARD_CASES))
def test_vocab_shard_kernels_match_their_twins(cuda_device, name):
    case = pc.shard_case(*pc.SHARD_CASES[name])
    assert pc.compare_shards(case) == {"gather_lattice": 0.0,
                                       "flat_write": 0.0}


def test_nccl_one_rank_sharded_loss_equals_rnnt_loss(cuda_device, nccl_world):
    from warp_rnnt_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cuda:0")
    launches, errs = pc.check_main_1rank(
        mesh, pc.make_inputs(**SMALL_MAIN, seed=1))
    assert set(pc.MAIN_PATH) <= set(launches)
    assert max(errs.values()) <= 1e-6


@pytest.mark.parametrize("mode", ["from_logits", "gather", "fused"])
def test_nccl_one_rank_sharded_train_step(cuda_device, nccl_world, mode):
    from warp_rnnt_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cuda:0")
    r = pc.check_train_step(mesh, mode, dims=tc.SMALL, seed=3)
    assert r["grads"] <= 1.0 and r["moved"] <= tc.STEP_ATOL
    assert r["vocab_grads"] <= 1.0
