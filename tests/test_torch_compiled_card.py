"""The compiled loss+grad on the card (`cuda`-marked; skipped without a
GPU).  The checks live in `warp_rnnt_tpu_torch/benchmarks/compiled_cases.py`,
which `chip_smoke.py` (`phase_compiled_main`) runs at the main path's and
the README table's widths; here they run at small ones:
  * compiled against eager bit for bit (loss, gradient, no-grad costs) in
    every variant, fp32 and bf16, 4-D and flat, on the capture's inputs
    and on new ones copied in; the gradient in the donated buffer;
  * a donated chain of 50 calls: no input copies, no memory growth; a
    replay launches an eager call's kernels;
  * the debug canary warns after each replay;
  * the benchmarks' compiled timers give a positive ms and leave no graph
    cached;
  * a host read inside the step fails the capture: no fallback to eager;
    the compact layout without its static bounds (whose lengths it would
    read) fails it with JAX's message before any read.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch import rnnt_loss
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks import compiled_cases as cc
from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.utils import compiled_step as cs

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compiled_equals_eager(cuda_device, dtype, flat):
    r = cc.check_row(3, 20, 5, 12, dtype=dtype, flat=flat,
                     variants=tuple(cc.VARIANTS), profile=not flat)
    assert r["copies"] == 0 and r["memory_growth"] <= 0
    if not flat:
        assert r["kernels"]["compiled"] == r["kernels"]["eager"]


def test_canary_warns_after_each_replay(cuda_device):
    assert cc.check_canary() == 2


def test_compiled_timers(cuda_device):
    before = len(cs.entries())
    for grad in (True, False):
        assert bl.run_loss_bench(3, 40, 8, 28, 4, grad=grad) > 0
    assert len(cs.entries()) == before


def test_host_read_fails_the_capture(cuda_device):
    torch.manual_seed(0)
    xs = torch.randn(7 * 3, 5, device="cuda").log_softmax(-1)
    ys = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    xn = torch.tensor([3, 3], dtype=torch.int32, device="cuda")
    yn = torch.tensor([1, 1], dtype=torch.int32, device="cuda")

    def compact(x):
        with torch.no_grad():
            return (rnnt_loss(x, ys, xn, yn, compact=True),)

    step = cs.compiled_step(compact, key="compact host read")
    with pytest.raises(ValueError, match="requires static max_frames"):
        step(xs)
    assert step.entry is None

    def host_read(x):
        return (x * float(x.sum()),)

    step = cs.compiled_step(host_read, key="host read")
    with pytest.raises(RuntimeError):
        step(xs)
    assert step.entry is None
    torch.cuda.synchronize()
    assert timing.bench_grad_chain(
        bl.loss_grad_step(*bl.make_batch(0, 2, 8, 3, 6)[1:]),
        bl.make_batch(0, 2, 8, 3, 6)[0], 4) > 0  # the card still works
