"""The port's trainer support modules against the JAX package's, on the CPU.

`warp_rnnt_tpu_torch/models/checkpoint.py`: the round trip and resume of
`tests/test_checkpoint.py:16-41` (three steps, save, restore into a fresh
model and optimizer, one more step on both: losses and parameters equal to
rtol 1e-6), with the optimizer state; the ``step_{n}`` layout and
`latest_step`; the errors.

`warp_rnnt_tpu_torch/utils/batching.py` (a copy of the NumPy module): each
function equal to JAX's on the same inputs, errors included.
"""

import numpy as np
import pytest
import torch

from warp_rnnt_tpu.models import checkpoint as jckpt
from warp_rnnt_tpu.utils import batching as jb
from warp_rnnt_tpu_torch.models import init_model, make_train_step
from warp_rnnt_tpu_torch.models.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from warp_rnnt_tpu_torch.utils import batching as pb


def _trainer(seed=0):
    model, params, batch = init_model(
        seed, vocab_size=8, feat_dim=6, N=2, T=6, U=3, device="cpu",
        encoder_hidden=8, predictor_hidden=8, joint_hidden=8)
    opt = torch.optim.AdamW(params.values(), lr=1e-3, weight_decay=1e-4)
    return model, opt, make_train_step(model, opt), batch


def test_roundtrip_and_resume(tmp_path):
    model, opt, step, batch = _trainer()
    for _ in range(3):
        step(batch)
    out = save_checkpoint(tmp_path, model, opt, step=3)
    assert out == tmp_path / "step_3" and latest_step(tmp_path) == 3

    fresh, fresh_opt, fresh_step, _ = _trainer(seed=1)
    assert restore_checkpoint(tmp_path, fresh, fresh_opt) == 3

    # resumed training must match continued training exactly
    loss_cont = step(batch)
    loss_res = fresh_step(batch)
    np.testing.assert_allclose(float(loss_res), float(loss_cont), rtol=1e-6)
    res = dict(fresh.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(res[name].detach().numpy(),
                                   p.detach().numpy(), rtol=1e-6, err_msg=name)


def test_optimizer_state_round_trips(tmp_path):
    model, opt, step, batch = _trainer()
    for _ in range(2):
        step(batch)
    save_checkpoint(tmp_path, model, opt, step=2)
    fresh, fresh_opt, _, _ = _trainer(seed=1)
    restore_checkpoint(tmp_path, fresh, fresh_opt)
    want, got = opt.state_dict(), fresh_opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert want["state"].keys() == got["state"].keys()
    for k, s in want["state"].items():
        for name, v in s.items():
            assert torch.equal(torch.as_tensor(got["state"][k][name]),
                               torch.as_tensor(v)), (k, name)


def test_latest_step_and_layout_match_jax(tmp_path):
    """The ``step_{n}`` layout: both packages' `latest_step` read the same
    directories; a name past ``step_`` that is not a number is skipped."""
    model, opt, _, _ = _trainer()
    assert latest_step(tmp_path) is None
    for n in (0, 7, 12):
        save_checkpoint(tmp_path, model, step=n)
    (tmp_path / "step_tmp").mkdir()
    assert latest_step(tmp_path) == jckpt.latest_step(tmp_path) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0", "step_12", "step_7", "step_tmp"]
    assert restore_checkpoint(tmp_path, model, step=7) == 7


def test_restore_errors(tmp_path):
    model, opt, _, _ = _trainer()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_checkpoint(tmp_path, model)
    save_checkpoint(tmp_path, model, step=1)
    with pytest.raises(KeyError, match="no optimizer state"):
        restore_checkpoint(tmp_path, model, opt)


def test_save_replaces_a_step(tmp_path):
    model, opt, step, batch = _trainer()
    save_checkpoint(tmp_path, model, opt, step=4)
    step(batch)
    save_checkpoint(tmp_path, model, opt, step=4)
    fresh, fresh_opt, _, _ = _trainer(seed=1)
    restore_checkpoint(tmp_path, fresh, fresh_opt)
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("args", [(400, 40), (400, 40, 1), (37, 5, 3),
                                  (1, 1, 4), (1000, 7, 6)])
def test_length_buckets_match_jax(args):
    assert pb.length_buckets(*args) == jb.length_buckets(*args)


def _utterances(seed, n=5, F=3, T=20, U=6):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(rng.randint(1, T + 1), F).astype(np.float32)
             for _ in range(n)]
    labels = [rng.randint(1, 9, rng.randint(0, U + 1)).astype(np.int32)
              for _ in range(n)]
    return feats, labels


def test_bucket_for_matches_jax():
    buckets = jb.length_buckets(40, 8)
    for xn, yn in ((1, 0), (10, 2), (11, 2), (20, 4), (40, 8), (21, 1)):
        assert pb.bucket_for(xn, yn, buckets) == jb.bucket_for(xn, yn, buckets)
    for mod in (pb, jb):
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            mod.bucket_for(41, 1, buckets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pad_batch_matches_jax(seed):
    feats, labels = _utterances(seed)
    for got, want in zip(pb.pad_batch(feats, labels, (20, 6), pad_value=0.5),
                         jb.pad_batch(feats, labels, (20, 6), pad_value=0.5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for mod in (pb, jb):
        with pytest.raises(ValueError, match="exceeds bucket"):
            mod.pad_batch(feats, labels, (20, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_pack_and_unpack_match_jax(seed):
    rng = np.random.RandomState(seed)
    N, T, U, V = 3, 7, 4, 5
    xs = rng.randn(N, T, U, V).astype(np.float32)
    ys = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([7, 3, 1], np.int32)
    yn = np.array([3, 0, 2], np.int32)
    packed = pb.pack_padded_to_compact(xs, xn, yn)
    np.testing.assert_array_equal(packed, jb.pack_padded_to_compact(xs, xn, yn))
    np.testing.assert_array_equal(pb.pack_labels_to_compact(ys, yn),
                                  jb.pack_labels_to_compact(ys, yn))
    for kw in ({}, {"T": 9, "U": 5, "fill": -1.0}):
        np.testing.assert_array_equal(
            pb.unpack_compact_to_padded(packed, xn, yn, **kw),
            jb.unpack_compact_to_padded(packed, xn, yn, **kw))
