"""The port's twin of the JAX package's graft entry points
(`__graft_entry__.py:21-143`).

  * `entry(device)`: the flagship Transducer's forward loss (N=4, T=48,
    U=8, V=128, 80 features, hidden 128), as a function and its arguments.
  * `dryrun_multichip(n)`: on a process group of n ranks, a ('data',
    'model') mesh by the JAX rule (model 2 when n is even and at least 4,
    else 1), the full train step sharded over it (`parallel.train_parallel`:
    the batch over 'data', the joint's output projection over 'model'), one
    step of each of "from_logits" and "fused" from the same parameters,
    then the compact and the restricted losses with gradients over 'data'
    (`parallel.rnnt_loss_sharded`).  Every loss and gradient must be
    finite.  It takes an optional model and batch (global, the same on
    every rank), so that a caller can give it the JAX dry run's own
    (carried with `models.carry_flax_transducer`), and returns the four
    losses.

    python -m warp_rnnt_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]
                                                 [--backend gloo]

spawns the ranks (`multihost.spawn`; ``--device cuda`` puts rank r on
``cuda:r``, ``--device cuda:0`` puts every rank on one card, which takes
``--backend gloo``), runs `entry` first in this process, and prints JAX's
``dryrun_multichip OK: mesh=(DxM) ...`` line from rank 0.
"""

from __future__ import annotations

import argparse
import copy
import math

import numpy as np
import torch
import torch.distributed as dist

from warp_rnnt_tpu_torch.models import init_model, transducer_loss_fn
from warp_rnnt_tpu_torch.parallel.loss_parallel import (
    rnnt_loss_sharded,
    shard_packed,
)
from warp_rnnt_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_device,
    rank_device,
    shard_batch,
)
from warp_rnnt_tpu_torch.parallel.multihost import spawn
from warp_rnnt_tpu_torch.parallel.train_parallel import (
    make_sharded_train_step,
    shard_model,
)

VOCAB = 64


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is the mean RNN-T loss of the flagship
    model on its example batch."""
    model, _, batch = init_model(0, vocab_size=128, feat_dim=80, N=4, T=48,
                                 U=8, device=device, encoder_hidden=128,
                                 predictor_hidden=128, joint_hidden=128)

    def fwd(feats, labels, xn, yn):
        return transducer_loss_fn(model, (feats, labels, xn, yn))

    return fwd, batch


def mesh_shape(n_devices: int):
    """(data, model) by the JAX dry run's rule."""
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // model_par, model_par


def loss_inputs(data_par: int):
    """The JAX dry run's compact and restricted inputs, from numpy seed 0:
    (log-probs (N, T, UL+1, V) fp32, labels, xn, yn, label frames), N =
    2 * data_par, T=12, UL=3, V=24."""
    rng = np.random.RandomState(0)
    N, T, UL, V = 2 * data_par, 12, 3, 24
    lp = rng.randn(N, T, UL + 1, V).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    ys = rng.randint(1, V, size=(N, UL)).astype(np.int32)
    xn = np.full((N,), T, np.int32)
    yn = np.full((N,), UL, np.int32)
    lf = np.sort(rng.randint(0, T, size=(N, UL)), axis=1).astype(np.int32)
    return lp, ys, xn, yn, lf


def _finite(name, *xs):
    for x in xs:
        if not torch.isfinite(x).all():
            raise AssertionError(f"dryrun_multichip: {name} is not finite")


def dryrun_multichip(n_devices: int, device=None, model=None, batch=None,
                     verbose: bool = True):
    """One sharded train step in two loss modes and two sharded losses with
    gradients over ``n_devices`` ranks (the world of the default process
    group).  ``model`` and ``batch`` default to `init_model(0, ...)` at the
    JAX dry run's shapes; both are global and not changed.  Returns
    {"loss", "fused_loss", "compact_loss", "restricted_loss"} (floats),
    and rank 0 prints the JAX dry run's line."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of"
                         f" {n_devices} ranks, not {dist.get_world_size()}")
    data_par, model_par = mesh_shape(n_devices)
    mesh = make_mesh((data_par, model_par), ("data", "model"), device)
    dev = mesh_device(mesh)
    if model is None:
        model, _, batch = init_model(
            0, vocab_size=VOCAB, feat_dim=16, N=2 * data_par, T=16, U=4,
            device=dev, encoder_hidden=16, predictor_hidden=16,
            joint_hidden=16)
    local = shard_batch(mesh, batch)

    losses = {}
    for key, mode in (("loss", "from_logits"), ("fused_loss", "fused")):
        m = shard_model(copy.deepcopy(model).to(dev), mesh)
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)
        loss = make_sharded_train_step(m, opt, mesh, loss_mode=mode)(local)
        _finite(key, loss, *m.parameters())
        losses[key] = float(loss)

    lp, ys, xn, yn, lf = (torch.tensor(a, device=dev)
                          for a in loss_inputs(data_par))
    N, T, U, V = lp.shape
    xs, ys_p, xn_l, yn_l = shard_packed(mesh, lp.reshape(N * T * U, V),
                                        ys.reshape(-1), xn, yn)
    xs = xs.requires_grad_()
    loss = rnnt_loss_sharded(mesh, xs, ys_p, xn_l, yn_l, reduction="mean",
                             compact=True, max_frames=T, max_labels=U - 1)
    loss.backward()
    _finite("compact_loss", loss, xs.grad)
    losses["compact_loss"] = float(loss.detach())

    lp_l, ys_l, xn_l, yn_l, lf_l = shard_batch(mesh, (lp, ys, xn, yn, lf))
    lp_l = lp_l.requires_grad_()
    loss = rnnt_loss_sharded(mesh, lp_l, ys_l, xn_l, yn_l, reduction="mean",
                             label_frames=lf_l, left_context=T,
                             right_context=T)
    loss.backward()
    _finite("restricted_loss", loss, lp_l.grad)
    losses["restricted_loss"] = float(loss.detach())
    if verbose and dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh=({data_par}x{model_par}) "
              f"devices={n_devices} loss={losses['loss']:.4f} "
              f"fused_loss={losses['fused_loss']:.4f} "
              f"compact_loss={losses['compact_loss']:.4f} "
              f"restricted_loss={losses['restricted_loss']:.4f}", flush=True)
    return losses


def _rank_main(rank, device, n):
    dryrun_multichip(n, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    fn, batch = entry(rank_device(args.device, 0))
    loss = float(fn(*batch).detach())
    if not math.isfinite(loss):
        raise SystemExit(f"entry: loss {loss}")
    print(f"entry OK, loss = {loss}", flush=True)
    spawn(_rank_main, args.ranks, (args.ranks,), args.backend, args.device)


if __name__ == "__main__":
    main()
