"""Worker of the port's distributed tests (not a pytest module): `run` is
the function that `tests/test_torch_parallel.py` and
`tests/test_torch_parallel_train.py` start in each rank of a gloo world on
the CPU through `warp_rnnt_tpu_torch.parallel.multihost.spawn`
(`_torch_port_helpers.spawn_worlds`).  It imports torch and the port, never
JAX.

`run(rank, device, suite, out_dir)` reads ``out_dir/inputs.pkl`` (numpy
arrays and Flax-layout trees the test wrote from seeds), runs every case of
``suite`` and writes ``out_dir/<suite>.<rank>.pkl``: {case: result}, numpy
arrays and floats.  A case that raises records ("raised", type, message)
instead; the tests assert which cases must.  A suite that fails writes its
traceback to ``out_dir/<suite>.<rank>.err`` and raises.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from warp_rnnt_tpu_torch.models import carry_flax_transducer  # noqa: E402
from warp_rnnt_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    rnnt_loss_shard_map,
    rnnt_loss_sharded,
    shard_batch,
)
from warp_rnnt_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from warp_rnnt_tpu_torch.parallel.loss_parallel import shard_packed  # noqa: E402
from warp_rnnt_tpu_torch.parallel.multihost import (  # noqa: E402
    global_batch,
    initialize,
    pod_mesh,
)
from warp_rnnt_tpu_torch.parallel.train_parallel import (  # noqa: E402
    make_sharded_train_step,
    shard_model,
)
from warp_rnnt_tpu_torch.parallel.vocab import (  # noqa: E402
    shard_vocab,
    vocab_lattice,
    vocab_log_softmax,
)

MODES = ("from_logits", "gather", "fused")
REDUCTIONS = ("none", "sum", "mean")


def _t(arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _np(x):
    return x.detach().numpy().copy() if isinstance(x, torch.Tensor) else x


def _loss_and_grad(x, fn):
    """{"loss": fn(x), "grad": d sum(fn(x)) / d x} at this rank's shard
    ``x`` (the sum: "none" gives the rank's costs)."""
    x = x.detach().clone().requires_grad_()
    loss = fn(x)
    loss.sum().backward()
    return {"loss": _np(loss), "grad": _np(x.grad)}


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the tests assert the type and the message
        return ("raised", type(e).__name__, str(e))
    return ("returned",)


def suite_data4(rank, inp, out_dir):
    """A 1-D ('data',) world of 4 ranks."""
    mesh = make_mesh(device="cpu")
    out = {}
    local = shard_batch(mesh, _t(inp["shard_map"]))
    out["shard_map"] = {red: _np(rnnt_loss_shard_map(
        mesh, *local, reduction=red, impl="scan")) for red in REDUCTIONS}

    lp, ys, xn, yn = shard_batch(mesh, _t(inp["sharded"]))
    out["sharded"] = _loss_and_grad(lp, lambda x: rnnt_loss_sharded(
        mesh, x, ys, xn, yn, reduction="mean", impl="scan"))

    # ragged shards: rank r holds RAGGED[r] samples
    lp, ys, xn, yn = _t(inp["ragged"])
    lo = sum(inp["ragged_split"][:rank])
    hi = lo + inp["ragged_split"][rank]
    out["ragged"] = {}
    for red in ("sum", "mean"):
        out["ragged"][red] = _loss_and_grad(
            lp[lo:hi], lambda x: rnnt_loss_sharded(
                mesh, x, ys[lo:hi], xn[lo:hi], yn[lo:hi], reduction=red,
                average_frames=True, impl="scan"))
    out["ragged_shard_map"] = _raised(lambda: rnnt_loss_shard_map(
        mesh, lp[lo:hi], ys[lo:hi], xn[lo:hi], yn[lo:hi], impl="scan"))

    xs, ys, xn, yn = shard_packed(mesh, *_t(inp["compact"]))
    T, L = inp["compact_bounds"]
    out["compact"] = {red: _loss_and_grad(xs, lambda x: rnnt_loss_sharded(
        mesh, x, ys, xn, yn, reduction=red, compact=True, impl="scan",
        max_frames=T, max_labels=L)) for red in REDUCTIONS}
    # no bounds: each rank's own lengths are shorter than the global ones
    out["compact_global_bounds"] = {
        red: _loss_and_grad(xs, lambda x: rnnt_loss_sharded(
            mesh, x, ys, xn, yn, reduction=red, compact=True, impl="scan"))
        for red in REDUCTIONS}

    lp, ys, xn, yn, lf = shard_batch(mesh, _t(inp["restricted"]))
    ctx = inp["restricted_contexts"]
    out["restricted"] = {red: _loss_and_grad(lp, lambda x: rnnt_loss_sharded(
        mesh, x, ys, xn, yn, reduction=red, label_frames=lf,
        left_context=ctx[0], right_context=ctx[1], impl="scan"))
        for red in REDUCTIONS}
    return out


def suite_grid(rank, inp, out_dir):
    """A 2x2 ('data', 'model') world: log-probs over both axes."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name in ("vocab", "vocab_blank5"):
        lp, ys, xn, yn = shard_batch(mesh, _t(inp[name]))
        blank = inp[f"{name}_blank"]
        lp = shard_vocab(mesh, lp)
        out[name] = {red: _loss_and_grad(lp, lambda x: rnnt_loss_sharded(
            mesh, x, ys, xn, yn, reduction=red, blank=blank,
            vocab_axis="model", impl="scan")) for red in REDUCTIONS}

    z, ys, xn, yn = shard_batch(mesh, _t(inp["logits"]))
    z = shard_vocab(mesh, z)

    def loss_from(x, normalize):
        lat = (vocab_lattice(vocab_log_softmax(x, mesh), ys, 0, mesh)
               if normalize else vocab_lattice(x, ys, 0, mesh,
                                               from_logits=True))
        return rnnt_loss_sharded(mesh, lat, ys, xn, yn, reduction="mean",
                                 blank=-1, impl="scan")

    out["from_logits"] = _loss_and_grad(z, lambda x: loss_from(x, False))
    out["log_softmax"] = _loss_and_grad(z, lambda x: loss_from(x, True))
    out["nondivisible"] = _raised(lambda: shard_vocab(
        mesh, torch.zeros(2, 7)))
    return out


def suite_multihost(rank, inp, out_dir):
    """2 processes through `initialize` and `global_batch`, as
    `tests/distributed_worker.py` runs JAX's: the process group `spawn`
    made is torn down and started again by `initialize` from the JAX
    module's three environment variables."""
    dist.destroy_process_group()
    os.environ.update(
        WARP_RNNT_NUM_PROCESSES="2", WARP_RNNT_PROCESS_ID=str(rank),
        WARP_RNNT_COORDINATOR="file://" + os.path.join(
            out_dir, "multihost.rendezvous"))
    initialize(device="cpu")
    mesh = pod_mesh(device="cpu")
    lp, ys, xn, yn = _t(inp["multihost"])
    lo, hi = rank * 4, (rank + 1) * 4
    batch = global_batch(mesh, (lp[lo:hi], ys[lo:hi], xn[lo:hi], yn[lo:hi]))
    out = {"loss": _np(rnnt_loss_shard_map(mesh, *batch, reduction="mean"))}
    bad = lp[lo:hi, :-1] if rank == 1 else lp[lo:hi]
    out["shapes_differ"] = _raised(lambda: global_batch(
        mesh, (bad, ys[lo:hi], xn[lo:hi], yn[lo:hi])))
    return out


def suite_train(rank, inp, out_dir):
    """A 2x2 world: one sharded train step in each loss mode from a carried
    fp32 tree, then the dry run on the JAX dry run's carried tree."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    batch = shard_batch(mesh, _t(inp["batch"]))
    out = {}
    for mode in MODES:
        model = carry_flax_transducer(inp["tree"], device="cpu",
                                      compute_dtype=torch.float32)
        shard_model(model, mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-4)
        loss = make_sharded_train_step(model, opt, mesh, loss_mode=mode)(batch)
        out[mode] = {"loss": _np(loss),
                     "params": {k: _np(p) for k, p in model.named_parameters()},
                     "grads": {k: _np(p.grad)
                               for k, p in model.named_parameters()}}
    model = carry_flax_transducer(inp["dryrun_tree"], device="cpu")
    out["dryrun"] = dryrun_multichip(4, "cpu", model, _t(inp["dryrun_batch"]),
                                     verbose=False)
    return out


def run(rank, device, suite, out_dir):
    """One rank of ``suite`` in a world that `multihost.spawn` started
    (``device`` is the CPU)."""
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    path = os.path.join(out_dir, f"{suite}.{rank}")
    try:
        out = globals()[f"suite_{suite}"](rank, inp, out_dir)
    except Exception:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(path + ".pkl.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".pkl.tmp", path + ".pkl")
