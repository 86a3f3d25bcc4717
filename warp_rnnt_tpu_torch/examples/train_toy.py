"""End-to-end toy training (counterpart of `examples/train_toy.py`): a small
Transducer learns a synthetic feature -> label mapping, then greedy and
beam decoding are evaluated and the labels force-aligned to frames.

    python -m warp_rnnt_tpu_torch.examples.train_toy [--steps 300]
        [--device cpu] [--data-parallel [--ranks 2]]

Runs on the card unless ``--device cpu``.  On one device the step is
`models.compiled_train_step`, as the JAX example jits its step: on the
card the whole step is one CUDA graph, replayed each step, its AdamW
built with ``capturable=True``; on the CPU it runs eagerly.
``--data-parallel`` spawns
``--ranks`` processes (`parallel.multihost.spawn`: gloo on the CPU, NCCL
on the cards, rank r on ``cuda:r``), each with the whole model and its
block of the batch (`parallel.make_mesh`, `shard_batch`), and trains with
`parallel.train_parallel.make_sharded_train_step`, as the JAX example
shards its batch over every device; that step runs eagerly (its
all-reduce is not captured).  The sharded loss relies on the
kernels' rule for columns outside a rank's vocabulary block (0 in the
gather, nothing written by the dense write, the plain twins masking alike;
`functional/gather.py`); this example's 1-D mesh has no 'model' axis, so
every rank holds the whole vocabulary.  Rank 0 prints, and decodes the
whole batch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from warp_rnnt_tpu_torch import rnnt_alignment
from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode, init_model
from warp_rnnt_tpu_torch.models.transducer import compiled_train_step
from warp_rnnt_tpu_torch.parallel import make_mesh, shard_batch
from warp_rnnt_tpu_torch.parallel.multihost import spawn
from warp_rnnt_tpu_torch.parallel.train_parallel import (
    make_sharded_train_step,
    shard_model,
)


def synthetic_batch(rng, N, T, U, vocab, feat_dim, device):
    """Labels are recoverable from features: feature frames carry one-hot
    hints of the label sequence."""
    labels = rng.randint(1, vocab, size=(N, U)).astype(np.int32)
    feats = rng.randn(N, T, feat_dim).astype(np.float32) * 0.1
    for i in range(N):
        for u in range(U):
            t = int((u + 0.5) * T / U)
            feats[i, t, labels[i, u] % feat_dim] += 3.0
    xn = np.full((N,), T, np.int32)
    yn = np.full((N,), U, np.int32)
    return tuple(torch.tensor(x, device=device)
                 for x in (feats, labels, xn, yn))


def recovered(tokens, lengths, labels):
    U = labels.shape[1]
    return int(((lengths == U) & (tokens[:, :U] == labels).all(1)).sum())


def train(args, device, mesh=None):
    """Train, then decode and align on rank 0 (every rank without a
    mesh)."""
    vocab, T, U, feat_dim = 16, 24, 4, 16
    rng = np.random.RandomState(0)
    batch = synthetic_batch(rng, args.batch, T, U, vocab, feat_dim, device)
    model, _, _ = init_model(0, vocab_size=vocab, feat_dim=feat_dim,
                             device=device, encoder_hidden=64,
                             predictor_hidden=64, joint_hidden=64)
    lead = mesh is None or mesh.get_rank() == 0
    if mesh is None:
        opt = torch.optim.AdamW(model.parameters(), lr=3e-3,
                                weight_decay=1e-4,
                                capturable=device.type == "cuda")
        step, local = compiled_train_step(model, opt), batch
    else:
        shard_model(model, mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-3,
                                weight_decay=1e-4)
        step = make_sharded_train_step(model, opt, mesh)
        local = shard_batch(mesh, batch)
        if lead:
            print(f"data-parallel over {mesh.size()} ranks ({device.type})")
    for i in range(args.steps):
        loss = step(local)
        if lead and (i % 50 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {float(loss):.4f}")
    if not lead:
        return

    feats, labels, xn, yn = batch
    tokens, lengths = greedy_decode(model, feats, xn, max_length=U + 2)
    print(f"greedy decode: {recovered(tokens, lengths, labels)}/{args.batch}"
          " sequences exactly recovered")
    b_tokens, b_lengths, b_scores = beam_decode(model, feats, xn,
                                                max_length=U + 2, beam_size=4)
    print(f"beam-4 decode: {recovered(b_tokens, b_lengths, labels)}/"
          f"{args.batch} exactly recovered (mean path log-prob"
          f" {float(b_scores.mean()):.3f})")

    with torch.no_grad():
        log_probs = model(feats, labels)
    _, frames = rnnt_alignment(log_probs, labels, xn, yn)
    print(f"forced alignment of sample 0: labels {labels[0].tolist()} "
          f"emitted at frames {frames[0].tolist()}")


def _train_rank(rank, device, args):
    train(args, device, make_mesh(device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if args.data_parallel:
        spawn(_train_rank, args.ranks, (args,), device=args.device)
    else:
        train(args, torch.device(args.device))


if __name__ == "__main__":
    main()
