"""The one generator of every traffic mix.

A mix is a data file, `traffic/<name>.json`, of parameters; this module
turns it and a seed into the cell's inputs, on the device, from one
`torch.Generator` on the card.  The same seed gives the same inputs.

Parameters a mix may set:

  * ``N``, ``T``, ``U``, ``V``: batch, frames, lattice rows (labels + 1),
    vocabulary;
  * ``frames``, ``labels``: [lo, hi] ranges (inclusive) from which each
    utterance's valid frames and labels are drawn uniformly; the first
    utterance of every batch takes ``T`` frames and ``U - 1`` labels, so
    every batch spans the whole lattice and every seed does the same
    padded work;
  * ``pool``: how many batches are drawn; the window takes them in turn;
  * ``feat_dim``: the width of the features a batch carries (drawn
    normal), where the cell's entry feeds a model;
  * ``buckets``: [[frames, count], ...] for requests of ``N`` utterances
    padded to a bucket of frames: ``count`` requests a bucket, in an
    order drawn from the seed, so every seed asks for the same work.  An
    utterance's valid frames are uniform in [frames / 2, frames], the
    first one's full; its features past them are zero.
"""

from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    """The parameters of the mix ``name`` (`traffic/<name>.json`)."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def generator(seed: int, device) -> torch.Generator:
    """The cell's generator: any whole number is a seed."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _uniform(gen, lo, hi, shape, device):
    return torch.randint(int(lo), int(hi) + 1, shape, generator=gen,
                         device=device, dtype=torch.int32)


def pool(mix: dict, gen: torch.Generator, device) -> list:
    """``mix["pool"]`` batches, each a dict of ``xn`` (N,), ``yn`` (N,) and
    ``labels`` (N, U - 1) int32 in [1, V) (blank is 0), and ``feats``
    (N, T, feat_dim) fp32 where the mix sets ``feat_dim``."""
    N, T, U, V, P = (mix[k] for k in ("N", "T", "U", "V", "pool"))
    xn = _uniform(gen, *mix["frames"], (P, N), device)
    yn = _uniform(gen, *mix["labels"], (P, N), device)
    xn[:, 0], yn[:, 0] = T, U - 1
    labels = _uniform(gen, 1, V - 1, (P, N, U - 1), device)
    feats = None
    if "feat_dim" in mix:
        feats = torch.randn((P, N, T, mix["feat_dim"]), generator=gen,
                            device=device)
    return [{"xn": xn[i].contiguous(), "yn": yn[i].contiguous(),
             "labels": labels[i].contiguous(),
             **({} if feats is None else {"feats": feats[i]})}
            for i in range(P)]


def log_probs(mix: dict, gen: torch.Generator, device,
              block: int = 8) -> torch.Tensor:
    """One (N, T, U, V) fp32 tensor of log-softmax outputs: normal logits
    drawn in one call, normalised in place a few utterances at a time."""
    N, T, U, V = (mix[k] for k in ("N", "T", "U", "V"))
    x = torch.randn((N, T, U, V), generator=gen, device=device)
    for i in range(0, N, block):
        x[i:i + block] = torch.log_softmax(x[i:i + block], dim=-1)
    return x


def requests(mix: dict, gen: torch.Generator, device) -> list:
    """The requests of a bucketed mix: [{"feats" (N, frames, feat_dim),
    "xn" (N,) int32}], the buckets' requests in an order from the seed."""
    N, F = mix["N"], mix["feat_dim"]
    sizes = [int(T) for T, count in mix["buckets"] for _ in range(count)]
    order = torch.randperm(len(sizes), generator=gen, device=device).tolist()
    out = []
    for i in order:
        T = sizes[i]
        xn = _uniform(gen, T // 2, T, (N,), device)
        xn[0] = T
        feats = torch.randn((N, T, F), generator=gen, device=device)
        t = torch.arange(T, device=device)[None, :, None]
        out.append({"feats": feats.masked_fill(t >= xn[:, None, None], 0.0),
                    "xn": xn})
    return out
