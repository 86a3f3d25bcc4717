"""The TensorFlow front end's torch half on the card (`cuda`-marked;
skipped without a GPU).

The checks live in `warp_rnnt_tpu_torch/benchmarks/bridge_cases.py`, which
`chip_smoke.py` phase 18 runs at the main path's full width; here they run
at small ones, with blank=0, blank=V-1 and pre-gathered, on ragged
lengths: the bridge's torch half launches exactly its path's kernels,
agrees with the plain version (costs rtol 1e-5, gradient 5e-3 of the
largest) and equals the direct `rnnt_loss` loss+grad bit for bit.
"""

import pytest
import torch

from _torch_port_helpers import cuda_device, loss_inputs  # noqa: F401
from warp_rnnt_tpu_torch.benchmarks import bridge_cases as bc

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("blank", [0, -1, 12])
def test_bridge_torch_half_on_card(cuda_device, blank):
    xs, ys, xn, yn = (torch.tensor(a, device=cuda_device)
                      for a in loss_inputs(21, N=5, T=33, U=7, V=13))
    if blank == 12:
        ys = torch.where(ys == blank, 1, ys)
    errs, launches = bc.check_bridge(xs, ys, xn, yn, blank=blank)
    assert errs["direct"] == 0.0
    assert set(launches) == set(bc.BRIDGE_KERNELS[min(blank, 0)])
