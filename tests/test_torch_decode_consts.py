"""The decoders' kept loop invariants (`models.decoding.decode_consts`),
on the CPU, and one `cuda` case on the card:
  * a second call returns the kept tensors themselves;
  * an in-place update through a parameter it reads (its version bumped)
    makes the next call rebuild them, equal to fresh ones
    (`decoding._make_consts`); a write through ``.data``, which bumps no
    version, needs `forget_decode_consts`, and after it they are rebuilt;
  * `transducer.compiled_train_step` and `checkpoint.restore_checkpoint`
    drop them (on the card a graph's replay updates the weights without
    bumping their versions): rebuilt after one step, after a restore, and
    after a graphed train step on the card (`cuda`);
  * greedy and beam decodes on the fp32 model equal JAX's, then the
    joint's weights are updated in place and both decode again: the port
    still equals JAX's new decodes (JAX is imported inside those tests
    only, so the card runs this file's `cuda` case without it).
"""

import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair, cuda_device  # noqa: F401
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    carry_flax_transducer,
    greedy_decode,
    init_model,
)
from warp_rnnt_tpu_torch.models import decoding
from warp_rnnt_tpu_torch.models.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from warp_rnnt_tpu_torch.models.transducer import compiled_train_step

PARAMS = ("joint.pre.weight", "joint.pre.bias", "joint.out.weight",
          "joint.out.bias", "predictor.bias_hn")
N, T, F, V, H, ML = 4, 23, 9, 21, 24, 12
XN = np.array([23, 19, 11, 4], np.int32)
SCORE_ATOL = 1e-4  # test_torch_decoding.py's


def _small(seed=0, device="cpu"):
    return init_model(seed, vocab_size=11, feat_dim=6, N=2, T=8, U=3,
                      device=device, encoder_hidden=16, predictor_hidden=16,
                      joint_hidden=16)


def _consts(model):
    with torch.inference_mode():
        return decoding.decode_consts(model)


def _assert_fresh(dc, model):
    with torch.inference_mode():
        fresh = decoding._make_consts(model)
    assert dc[1:] == fresh[1:]
    for a, b in zip(dc.tensors, fresh.tensors):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _values(dc):
    return [t.clone() for t in dc.tensors]


def test_second_call_returns_the_kept_tensors():
    model = _small()[0]
    first, again = _consts(model), _consts(model)
    assert again is first
    assert all(a is b for a, b in zip(first.tensors, again.tensors))


@pytest.mark.parametrize("name", PARAMS)
def test_rebuilt_after_an_in_place_update(name):
    model = _small()[0]
    first = _values(_consts(model))
    p = dict(model.named_parameters())[name]
    with torch.no_grad():
        p.add_(0.25)
    got = _consts(model)
    _assert_fresh(got, model)
    assert not all(torch.equal(a, b) for a, b in zip(got.tensors, first))


def test_a_write_through_data_is_dropped_by_forget():
    model = _small()[0]
    first = _values(_consts(model))
    p = model.joint.out.weight
    version = p._version
    p.data.add_(0.25)
    assert p._version == version  # what the key cannot see
    decoding.forget_decode_consts(model)
    assert model not in decoding._CONSTS
    got = _consts(model)
    _assert_fresh(got, model)
    assert not torch.equal(got.tensors[2], first[2])


def test_compiled_train_step_drops_them():
    model, _, batch = _small()
    first = _values(_consts(model))
    step = compiled_train_step(model, torch.optim.AdamW(model.parameters(),
                                                        lr=1e-2))
    step(batch)
    assert model not in decoding._CONSTS
    got = _consts(model)
    _assert_fresh(got, model)
    assert not all(torch.equal(a, b) for a, b in zip(got.tensors, first))


def test_checkpoint_restore_drops_them(tmp_path):
    model, other = _small(0)[0], _small(1)[0]
    save_checkpoint(tmp_path, other, step=3)
    _consts(model)
    assert restore_checkpoint(tmp_path, model) == 3
    assert model not in decoding._CONSTS
    got = _consts(model)
    _assert_fresh(got, model)
    want = _consts(other)
    assert all(torch.equal(a, b) for a, b in zip(got.tensors, want.tensors))


@pytest.mark.cuda
def test_rebuilt_after_a_graphed_train_step(cuda_device):
    model, _, batch = _small(device=cuda_device)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, capturable=True)
    step = compiled_train_step(model, opt)
    step(batch)  # captures the step's graph
    assert step.compiled.entry is not None
    first = _values(_consts(model))
    step(batch)  # a replay: no Python, no version bumped
    got = _consts(model)
    _assert_fresh(got, model)
    assert not all(torch.equal(a, b) for a, b in zip(got.tensors, first))


def _decodes(port, feats):
    f, xn = torch.tensor(feats), torch.tensor(XN)
    return greedy_decode(port, f, xn, ML), beam_decode(port, f, xn, ML,
                                                       beam_size=3)


def _jax_decodes(model, params, feats):
    import jax.numpy as jnp
    from warp_rnnt_tpu.models import beam_decode as jax_beam
    from warp_rnnt_tpu.models import greedy_decode as jax_greedy

    f = jnp.asarray(feats)
    return ([np.asarray(x) for x in jax_greedy(model, params, f, XN, ML)],
            [np.asarray(x) for x in jax_beam(model, params, f, XN, ML,
                                             beam_size=3)])


def _assert_matches_jax(got, want):
    (gt, gl), (bt, bl, bs) = got
    (wgt, wgl), (wbt, wbl, wbs) = want
    np.testing.assert_array_equal(gl.numpy(), wgl)
    np.testing.assert_array_equal(gt.numpy(), wgt)
    np.testing.assert_array_equal(bl.numpy(), wbl)
    np.testing.assert_array_equal(bt.numpy(), wbt)
    np.testing.assert_allclose(bs.numpy(), wbs, rtol=0, atol=SCORE_ATOL)


def test_decodes_match_jax_before_and_after_an_update():
    import jax

    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair("fp32", 2, feats, V, H)
    before = _decodes(port, feats)
    _assert_matches_jax(before, _jax_decodes(model, params, feats))
    # the joint's logits negated: every argmax moves
    joint = params["params"]["joint"]
    new = {**params, "params": {**params["params"], "joint": {
        **joint, "out": {k: -v for k, v in joint["out"].items()}}}}
    updated = carry_flax_transducer(jax.tree_util.tree_map(np.asarray, new),
                                    device="cpu", compute_dtype=torch.float32)
    with torch.no_grad():
        for p, q in zip(port.parameters(), updated.parameters()):
            p.copy_(q)
    after = _decodes(port, feats)
    assert not torch.equal(after[0][0], before[0][0])
    _assert_matches_jax(after, _jax_decodes(model, new, feats))
