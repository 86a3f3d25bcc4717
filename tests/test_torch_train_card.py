"""The port's transducer train step on the card, against the port's own CPU
step (`warp_rnnt_tpu_torch/benchmarks/train_cases.py`, which
`chip_smoke.py` runs too).  The `cuda`-marked tests skip without a CUDA
device.  This file imports neither flax nor optax (the card has neither),
so the JAX parity tests of the model stay in `tests/test_torch_transducer.py`.

  * one small train step on the card equals the CPU step in each loss mode
    (loss and gradients: `train_cases.compare_grads`' tolerance; parameters
    after one AdamW step: `train_cases.compare_steps`, within 1e-2 lr where
    the two gradients share a sign above 1e-5), and launches exactly the
    mode's kernels;
  * at a joint wider than one 256-column slice (H=320) each mode launches
    exactly its kernels (`train_cases.PATHS`), the fused h image among
    them, and the lattice once a step; that lattice sweep equals the plain
    version in float64 (`train_cases.lattice_matches_plain`);
  * on the CPU, the two checks fail where they should: `compare_steps` on
    a step with another lr and on a NaN parameter, `lattice_matches_plain`
    on perturbed costs, betas and gradients.
"""

import copy

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

MODES = ("from_logits", "gather", "fused")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_card_step_matches_cpu(cuda_device, mode):
    worst, (moved, share), launches = tc.card_matches_cpu(mode)
    assert worst <= 1.0 and moved <= tc.STEP_ATOL and share > 0.5
    assert set(launches) == set(tc.expected(mode, tc.SMALL["H"]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_card_step_launches_the_mode_kernels(cuda_device, mode):
    model, batch = tc.carried(9, dict(tc.SMALL, H=320))
    with tc.recorded_lattice() as sweeps:
        loss, _, launches = tc.launches_per_step(model, batch, mode)
    assert np.isfinite(float(loss))
    assert set(launches) == set(tc.PATHS[mode])
    assert launches["lattice_fused"] == 1
    (sweep,) = sweeps
    assert tc.lattice_matches_plain(sweep, mode) <= 1e-3


def _stepped(lr=tc.LR):
    """Two copies of one small CPU model, each after one AdamW step on one
    batch; the second with ``lr``."""
    d = tc.SMALL
    model, _, batch = tc.init_model(
        3, vocab_size=d["V"], feat_dim=d["F"], N=d["N"], T=d["T"], U=d["U"],
        device="cpu", encoder_hidden=d["H"], predictor_hidden=d["H"],
        joint_hidden=d["H"])
    models = [model, copy.deepcopy(model)]
    for m, rate in zip(models, (tc.LR, lr)):
        opt = torch.optim.AdamW(m.parameters(), lr=rate,
                                weight_decay=tc.WEIGHT_DECAY)
        tc.make_train_step(m, opt)(batch)
    return models


@pytest.mark.parametrize("fault", [None, "lr", "nan"])
def test_compare_steps(fault):
    """The same step passes, exactly; a step with 1.5 lr moves the entries
    whose gradients agree by 0.5 lr more than the reference, and a NaN
    parameter fails every comparison."""
    ref, got = _stepped(lr=1.5 * tc.LR if fault == "lr" else tc.LR)
    if fault is None:
        moved, share = tc.compare_steps(ref, got, "same")
        assert moved == 0.0 and share > 0.5
        return
    if fault == "nan":
        with torch.no_grad():
            got.joint.pre.bias[0] = float("nan")
    with pytest.raises(AssertionError, match="after one AdamW step"):
        tc.compare_steps(ref, got, fault)


@pytest.mark.parametrize("fault", [None, "costs", "betas", "g_emit"])
def test_lattice_matches_plain_on_the_cpu(fault):
    """The plain float32 sweep (what a CPU lattice runs) passes against the
    float64 one; a relative 1e-4 on one cost, 1e-2 on one valid beta or 1 %
    of the largest on one emit gradient fails."""
    from warp_rnnt_tpu_torch.ops import cuda_impl

    rng = np.random.RandomState(0)
    n, t, u = 3, 20, 5
    blank, emit = (torch.tensor(np.log(rng.uniform(0.05, 0.95, (n, t, u))),
                                dtype=torch.float32) for _ in range(2))
    xn = torch.tensor([20, 13, 7], dtype=torch.int32)
    yn = torch.tensor([4, 2, 0], dtype=torch.int32)
    out = list(cuda_impl.forward_backward(blank, emit, xn, yn))
    if fault == "costs":
        out[0][1] *= 1 + 1e-4
    elif fault == "betas":
        out[4][1, 3, 1] += 1e-2
    elif fault == "g_emit":
        out[2][0, 2, 1] += 1e-2 * out[2].abs().max()
    call = (blank, emit, xn, yn, 0.0, tuple(out))
    if fault is None:
        assert tc.lattice_matches_plain(call, "cpu") <= 1e-4
    else:
        match = {"costs": "lattice costs", "betas": "lattice betas",
                 "g_emit": "lattice gradients"}[fault]
        with pytest.raises(AssertionError, match=match):
            tc.lattice_matches_plain(call, "cpu")
