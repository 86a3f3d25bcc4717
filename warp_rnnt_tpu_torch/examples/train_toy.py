"""End-to-end toy training (counterpart of `examples/train_toy.py`): a small
Transducer learns a synthetic feature -> label mapping, then greedy and
beam decoding are evaluated and the labels force-aligned to frames.

    python -m warp_rnnt_tpu_torch.examples.train_toy [--steps 300]
                                                     [--device cpu]

Runs on the card unless ``--device cpu``.  The JAX example's
``--data-parallel`` is left out until the port has a parallel tier.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from warp_rnnt_tpu_torch import rnnt_alignment
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    init_model,
    make_train_step,
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    vocab, T, U, feat_dim = 16, 24, 4, 16
    rng = np.random.RandomState(0)
    batch = synthetic_batch(rng, args.batch, T, U, vocab, feat_dim,
                            args.device)
    model, _, _ = init_model(0, vocab_size=vocab, feat_dim=feat_dim,
                             device=args.device, encoder_hidden=64,
                             predictor_hidden=64, joint_hidden=64)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, weight_decay=1e-4)
    step = make_train_step(model, opt)
    for i in range(args.steps):
        loss = step(batch)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")

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


if __name__ == "__main__":
    main()
