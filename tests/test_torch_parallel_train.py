"""Parity of the port's sharded train step and dry run
(`warp_rnnt_tpu_torch/parallel/train_parallel.py`, `parallel/dryrun.py`)
with the JAX package's, on the CPU.

One module-scoped spawn of a 2x2 ('data', 'model') gloo world
(`_torch_port_helpers.spawn_worlds` over `multihost.spawn`, 120 s) runs
`make_sharded_train_step` in the three loss modes from one carried Flax
tree (the fp32 variant, `fp32_transducer_class`), each rank on its block
of the batch and, under 'model', its block of the joint's output
projection; then
`dryrun_multichip(4)` on the tree and batch of the JAX dry run's own
`init_model(PRNGKey(0), ...)`.  Here, on the CPU: one step of JAX's
`make_train_step` on a (2, 2) mesh of virtual devices with the dry run's
shardings, and one step of the port's single-process `make_train_step`.

  * The sharded loss against the port's single-process step and against
    JAX's sharded step: rtol 1e-5 in every mode.
  * The parameters after one AdamW step, the sharded out projection put
    back together from the model ranks, by `train_cases.compare_steps`'
    rule, against both.
  * The dry run's four losses against JAX's printed ones (the bf16 model:
    loss rtol 2e-3; compact and restricted rtol 1e-5 and the print's 5e-5).
"""

import importlib.util
import os
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_port_helpers import fp32_transducer_class, spawn_worlds, world
from warp_rnnt_tpu.models import transducer as jt
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.models import carry_flax_transducer, make_train_step

MODES = ("from_logits", "gather", "fused")
N, T, U, F, V, H = 4, 12, 5, 10, 16, 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch():
    rng = np.random.RandomState(11)
    feats = rng.randn(N, T, F).astype(np.float32)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([T, 9, 12, 7], np.int32)
    yn = np.array([U - 1, 2, 3, 1], np.int32)
    return feats, labels, xn, yn


def _jax_setup():
    model = fp32_transducer_class()(vocab_size=V, encoder_hidden=H,
                                    predictor_hidden=H, joint_hidden=H)
    batch = _batch()
    params = nn.unbox(model.init(jax.random.PRNGKey(5),
                                 jnp.asarray(batch[0]), jnp.asarray(batch[1])))
    return model, params, batch


def _dryrun_setup():
    """The JAX dry run's model, params and batch at n = 4 (data 2)."""
    model, params, batch = jt.init_model(
        jax.random.PRNGKey(0), vocab_size=64, feat_dim=16, N=4, T=16, U=4,
        encoder_hidden=16, predictor_hidden=16, joint_hidden=16)
    return model, nn.unbox(params), tuple(np.asarray(x) for x in batch)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    _, params, batch = _jax_setup()
    _, dparams, dbatch = _dryrun_setup()
    inp = {"tree": _tree(params), "batch": batch,
           "dryrun_tree": _tree(dparams), "dryrun_batch": dbatch}
    out = tmp_path_factory.mktemp("torch_parallel_train")
    return world(spawn_worlds(out, inp, {"train": 4}), "train")


def _jax_sharded_step(model, params, batch, mode):
    """One step of JAX's `make_train_step` on a (2, 2) mesh, the batch over
    'data' and the joint's vocabulary leaves over 'model', as
    `__graft_entry__.dryrun_multichip` shards them.  Returns (new params,
    loss)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def spec(path, leaf):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if leaf.ndim >= 1 and leaf.shape[-1] == V and "joint" in names:
            return NamedSharding(mesh, P(*([None] * (leaf.ndim - 1)
                                          + ["model"])))
        return NamedSharding(mesh, P())

    p = jax.tree_util.tree_map_with_path(
        lambda path, x: jax.device_put(x, spec(path, x)), params)
    b = tuple(jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", *([None] * (x.ndim - 1))))) for x in batch)
    opt = optax.adamw(1e-3)
    new, _, loss = jax.jit(jt.make_train_step(model, opt, loss_mode=mode))(
        p, opt.init(p), b)
    return new, float(loss)


def _gathered_model(tree, ranks, mode):
    """The port's model holding the sharded step's parameters and
    gradients: data rank 0's, with the out projection's two vocabulary
    blocks (ranks 0 and 1) put back together."""
    model = carry_flax_transducer(tree, device="cpu",
                                  compute_dtype=torch.float32)
    r0, r1 = ranks[0][mode], ranks[1][mode]
    with torch.no_grad():
        for name, p in model.named_parameters():
            value, grad = r0["params"][name], r0["grads"][name]
            if name.startswith("joint.out."):
                value = np.concatenate([value, r1["params"][name]])
                grad = np.concatenate([grad, r1["grads"][name]])
            p.copy_(torch.from_numpy(value))
            p.grad = torch.from_numpy(grad)
    return model


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_matches_single_process_and_jax(results, mode):
    jmodel, params, batch = _jax_setup()
    tree = _tree(params)
    ranks = results
    loss = float(ranks[0][mode]["loss"])
    for r in ranks[1:]:
        assert float(r[mode]["loss"]) == loss
    # data ranks hold the same parameters after the step; model ranks the
    # same replicated ones
    for name, value in ranks[0][mode]["params"].items():
        np.testing.assert_array_equal(ranks[2][mode]["params"][name], value)
        if not name.startswith("joint.out."):
            np.testing.assert_array_equal(ranks[1][mode]["params"][name],
                                          value)
    got = _gathered_model(tree, ranks, mode)

    single = carry_flax_transducer(tree, device="cpu",
                                   compute_dtype=torch.float32)
    opt = torch.optim.AdamW(single.parameters(), lr=tc.LR,
                            weight_decay=tc.WEIGHT_DECAY)
    single_loss = float(make_train_step(single, opt, loss_mode=mode)(
        tuple(torch.tensor(x) for x in batch)))
    np.testing.assert_allclose(loss, single_loss, rtol=1e-5)
    tc.compare_steps(single, got, f"sharded {mode} vs single process")

    new, jloss = _jax_sharded_step(jmodel, params, batch, mode)
    jb = tuple(jnp.asarray(x) for x in batch)
    jgrads = jax.grad(lambda p: jt.transducer_loss_fn(jmodel, p, jb,
                                                      loss_mode=mode))(params)
    want = carry_flax_transducer(_tree(new), device="cpu")
    gmodel = carry_flax_transducer(_tree(jgrads), device="cpu")
    for (name, p), g in zip(want.named_parameters(), gmodel.parameters()):
        p.grad = g.detach()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    tc.compare_steps(want, got, f"sharded {mode} vs JAX")


def _jax_dryrun_losses(capsys):
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    entry.dryrun_multichip(4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh=(2x2) devices=4"), line
    return {k: float(v) for k, v in re.findall(r"(\w+_?\w*)=(-?[\d.]+)",
                                                line) if k.endswith("loss")}


def test_dryrun_matches_jax_dryrun(results, capsys):
    want = _jax_dryrun_losses(capsys)
    assert set(want) == {"loss", "fused_loss", "compact_loss",
                         "restricted_loss"}
    got = results[0]["dryrun"]
    for r in results[1:]:
        assert r["dryrun"] == got
    for key in ("loss", "fused_loss"):
        assert abs(got[key] - want[key]) <= tc.LOSS_RTOL * abs(want[key]), key
    for key in ("compact_loss", "restricted_loss"):
        assert abs(got[key] - want[key]) <= 5e-5 + 1e-5 * abs(want[key]), key
