"""The compiled train step (`models.transducer.compiled_train_step`, the
port's ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``) and the
compiled step's hook for state updated in place
(`utils.compiled_step._undone`), on the CPU, where the step runs eagerly.

  * The step after 1 and 3 calls against JAX's jitted, donated
    `make_train_step` with ``optax.adamw(1e-3)``, in the three loss modes,
    the weights carried by `carry_flax_transducer`: the fp32 variant of
    `tests/test_torch_transducer.py::test_adamw_steps_match_optax`, with
    its tolerances (losses rtol 1e-5, parameters within 1e-5).  "fused",
    whose joint is bf16 in both packages (its gradients round in other
    places), holds them after 1 step (Adam's first step is lr g / |g|);
    after 3, 99 % of its entries are within 1e-5 (seen: 99.5 %, the
    largest 1.6e-4 in the GRU's and convolutions' weights) and every one
    within lr.
  * The hook: after a train step inside `_undone`, every parameter and
    optimizer state tensor equals its value before, at the same
    ``data_ptr``; state the step created (AdamW's on a fresh optimizer) is
    zero; an exception inside the block restores too.
  * `compiled_train_step` is in no ``__all__``; its key follows the mode,
    ``model.training`` and the parameters' addresses; the cases' code
    (`benchmarks/compiled_train_cases.py`) runs on the CPU; the train
    benchmark needs a card.
The card's checks (the first call applies exactly one update, the
refusal of a non-capturable optimizer) are in
`tests/test_torch_compiled_train_card.py`.
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import fp32_transducer_class
from warp_rnnt_tpu.models import transducer as jt
from warp_rnnt_tpu_torch.benchmarks import bench_train
from warp_rnnt_tpu_torch.benchmarks import compiled_train_cases as ctc
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.models import carry_flax_transducer, init_model
from warp_rnnt_tpu_torch.models.transducer import (
    compiled_train_step,
    make_train_step,
    train_state,
)
from warp_rnnt_tpu_torch.utils import compiled_step as cs

MODES = ("from_logits", "gather", "fused")
N, T, U, F, V, HE, HP, HJ = 3, 12, 5, 10, 17, 24, 24, 32
FP32_RTOL = 1e-5  # tests/test_torch_transducer.py
FUSED_SHARE = 0.99  # fused after 3 steps: entries within 1e-5 (seen 0.995)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, F).astype(np.float32)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([T, 9, 5], np.int32)
    yn = np.array([U - 1, 2, 1], np.int32)
    return feats, labels, xn, yn


@pytest.mark.parametrize("mode", MODES)
def test_compiled_step_matches_jax_jit(mode):
    model = fp32_transducer_class()(vocab_size=V, encoder_hidden=HE,
                                    predictor_hidden=HP, joint_hidden=HJ)
    batch = _inputs(8)
    jb = tuple(jnp.asarray(x) for x in batch)
    params = nn.unbox(model.init(jax.random.PRNGKey(3), jb[0], jb[1]))
    port = carry_flax_transducer(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu", compute_dtype=torch.float32)
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    jstep = jax.jit(jt.make_train_step(model, opt, loss_mode=mode),
                    donate_argnums=(0, 1))
    pstep = compiled_train_step(port, torch.optim.AdamW(
        port.parameters(), lr=1e-3, weight_decay=1e-4), loss_mode=mode)
    tb = tuple(torch.tensor(x) for x in batch)
    for k in range(1, 4):
        params, state, jloss = jstep(params, state, jb)
        ploss = pstep(tb)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=FP32_RTOL)
        if k not in (1, 3):
            continue
        want = carry_flax_transducer(jax.tree_util.tree_map(np.asarray, params),
                                     device="cpu")
        got = dict(port.named_parameters())
        within, total = 0, 0
        for name, w in want.named_parameters():
            g, w = got[name].detach().numpy(), w.detach().numpy()
            assert np.isfinite(g).all(), name
            if mode != "fused" or k == 1:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                           err_msg=f"{name} after {k} steps")
            else:
                assert np.abs(g - w).max() <= tc.LR, (name, k)
                within += int((np.abs(g - w) <= 1e-5).sum())
                total += g.size
        assert within >= FUSED_SHARE * total


def _small(seed=0):
    return init_model(seed, vocab_size=11, feat_dim=6, N=2, T=8, U=3,
                      device="cpu", encoder_hidden=16, predictor_hidden=16,
                      joint_hidden=16)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "stepped"])
def test_undone_restores_state_in_place(fresh):
    model, _, batch = _small()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = make_train_step(model, opt)
    if not fresh:
        step(batch)
    before = train_state(model, opt)
    values = [t.detach().clone() for t in before]
    with cs._undone(lambda: train_state(model, opt)):
        step(batch)
        assert not all(torch.equal(a, b) for a, b in zip(before, values))
    after = train_state(model, opt)
    assert len(after) == 3 * len(list(model.parameters())) + len(
        list(model.parameters()))
    for t, v, b in zip(after, values, before):
        assert t is b and t.data_ptr() == b.data_ptr()
        assert torch.equal(t, v)
    created = after[len(before):]
    assert len(created) == (3 * len(list(model.parameters())) if fresh else 0)
    assert all(not t.any() for t in created)


def test_undone_restores_after_an_exception():
    model, _, batch = _small()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    values = [t.detach().clone() for t in train_state(model, opt)]
    with pytest.raises(RuntimeError, match="stop"):
        with cs._undone(lambda: train_state(model, opt)):
            make_train_step(model, opt)(batch)
            raise RuntimeError("stop")
    for t, v in zip(train_state(model, opt), values):
        assert torch.equal(t, v)


def test_undone_of_none_names_nothing():
    with cs._undone(None):
        pass


def test_compiled_step_passes_its_state_to_the_capture():
    """On the CPU nothing is captured; the state hook is kept on the step
    and names the parameters, then the optimizer's state."""
    model, _, batch = _small()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = compiled_train_step(model, opt)
    assert step.compiled.state is not None
    n = len(list(model.parameters()))
    assert len(step.compiled.state()) == n
    step(batch)
    assert len(step.compiled.state()) == 4 * n
    assert step.compiled.entry is None  # eager on the CPU


def test_compiled_train_step_key_follows_mode_and_addresses():
    model, _, batch = _small()
    step = compiled_train_step(model, torch.optim.AdamW(model.parameters()))
    step(batch)
    key = step.compiled.key
    model.eval()
    step(batch)
    assert step.compiled.key != key and step.compiled.key[-1] is False
    model.train()
    step(batch)
    assert step.compiled.key == key
    other = compiled_train_step(model, torch.optim.AdamW(model.parameters()),
                                loss_mode="gather")
    other(batch)
    assert other.compiled.key != key
    assert key[3] == tuple(p.data_ptr() for p in model.parameters())


@pytest.mark.parametrize("sub", ["", ".functional", ".models", ".parallel",
                                 ".utils"])
def test_compiled_train_step_is_not_exported(sub):
    mod = importlib.import_module("warp_rnnt_tpu_torch" + sub)
    assert "compiled_train_step" not in mod.__all__
    assert "train_state" not in mod.__all__


def test_compiled_train_step_refuses_an_unknown_mode():
    model, _, _ = _small()
    with pytest.raises(ValueError, match="unknown loss_mode"):
        compiled_train_step(model, torch.optim.AdamW(model.parameters()),
                            loss_mode="compact")


@pytest.mark.parametrize("mode", MODES)
def test_train_check_runs_on_cpu(mode):
    r = ctc.check_train(mode, tc.SMALL, seed=5, K=3, device="cpu")
    assert r["bit_for_bit"] and r["eager_differs"] == []
    assert r["vs_non_capturable"][0] == 0.0
    assert "capture_ms" not in r


def test_bench_train_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_train.bench_train(N=2, T=8, U=3, V=11, feat_dim=6, hidden=16)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_train.main("2", "8", "3", "11", "gather", "--eager")
