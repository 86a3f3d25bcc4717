"""The compiled train step and the compiled compact loss on the card
(`cuda`-marked; skipped without a GPU).  The checks live in
`warp_rnnt_tpu_torch/benchmarks/compiled_train_cases.py`, which
`chip_smoke.py` (`phase_compiled_train`) runs at `bench_train`'s width
and at compact cases A and B; here they run at small widths:

  * in each loss mode, the first compiled call (the capture) from a fresh
    model and optimizer applies exactly one AdamW update: the parameters
    and AdamW's state equal one eager step's of the same capturable
    optimizer; 3 calls equal 3 eager steps; the loss falls; the step
    against the eager, non-capturable step within
    `train_cases.STEP_ATOL`; at a joint wider than one 256-column slice
    too;
  * an optimizer that is not capturable is refused with a ValueError;
  * the compact loss+grad and no-grad costs compiled with static bounds
    equal the eager calls bit for bit; under a bound below a length the
    clamped lengths keep the kernels in their buffers: the result equals
    the eager call on the clamped lengths;
  * `bench_train` gives the compiled and the eager readings in one call,
    and ``--eager`` the eager one alone.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import bench_train
from warp_rnnt_tpu_torch.benchmarks import compiled_train_cases as ctc
from warp_rnnt_tpu_torch.benchmarks import packed_cases
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.models.transducer import compiled_train_step
from warp_rnnt_tpu_torch.utils import compiled_step as cs

pytestmark = pytest.mark.cuda
MODES = ("from_logits", "gather", "fused")


@pytest.mark.parametrize("H", [32, 320])
@pytest.mark.parametrize("mode", MODES)
def test_first_call_applies_exactly_one_update(cuda_device, mode, H):
    r = ctc.check_train(mode, dict(tc.SMALL, H=H), seed=11, K=3)
    assert r["capture_ms"] > 0 and r["pool_mib"] >= 0
    assert r["vs_non_capturable"][1] > 0.5


def test_a_non_capturable_optimizer_is_refused(cuda_device):
    model, _ = tc.carried(12, tc.SMALL)
    opt = torch.optim.AdamW(model.parameters(), lr=tc.LR)
    with pytest.raises(ValueError, match="capturable=True"):
        compiled_train_step(model, opt)
    compiled_train_step(model, ctc.adamw(model, True))  # accepted


@pytest.mark.parametrize("name", ["generic ragged", "pad rows", "V=50",
                                  "bf16"])
def test_compiled_compact_equals_eager(cuda_device, name):
    xn, yn, V, pad, blank, dtype = packed_cases.CASES[name]
    case = packed_cases.make_case(xn, yn, V, pad, blank, dtype, 13)
    case["xs"] = torch.log_softmax(case["xs"].float(), -1).to(dtype)
    r = ctc.check_compact(case)
    assert r["capture_ms"]["loss_grad"] > 0


@pytest.mark.parametrize("which", ["frames", "labels"])
def test_traced_bound_below_a_length_stays_in_bounds(cuda_device, which):
    case = packed_cases.full_case(4, 20, 6, 9, seed=14)
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    T = case["T"] - 4 if which == "frames" else case["T"]
    L = case["U"] - 3 if which == "labels" else case["U"] - 1
    step = cs.compiled_step(
        lambda x: (_compact(x, ys, xn, yn, T, L),),
        key=("test bound below", which, T, L))
    try:
        (got,) = step(xs)
        want = _compact(xs, ys, xn.clamp(0, T), yn.clamp(0, L), T, L)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, want)
    finally:
        step.release()


def _compact(x, ys, xn, yn, T, L):
    from warp_rnnt_tpu_torch import rnnt_loss

    return rnnt_loss(x, ys, xn, yn, compact=True, max_frames=T, max_labels=L)


def test_bench_train_compiled_and_eager(cuda_device):
    d = dict(N=2, T=24, U=6, V=40, feat_dim=12, hidden=32, steps=4)
    r = bench_train.bench_train(**d, loss_mode="gather")
    assert r["compiled"] is True and r["capture_ms"] > 0
    assert r["step_ms"] > 0 and r["eager"]["step_ms"] > 0
    assert r["kernels_per_step"] > 0 and r["eager"]["kernels_per_step"] > 0
    r = bench_train.bench_train(**d, loss_mode="gather", compiled=False)
    assert r["compiled"] is False and "eager" not in r
