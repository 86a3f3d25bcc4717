"""Variable-length batching utilities (host-side data pipeline; a copy of
`warp_rnnt_tpu/utils/batching.py`, which the port may not import).

Bucket utterances by length and pad each batch to its bucket's bounds, so
a step sees few distinct (T, U) shapes, and convert between the padded and
compact layouts.  Pure NumPy.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def length_buckets(
    max_frames: int, max_labels: int, num_buckets: int = 4
) -> List[Tuple[int, int]]:
    """Geometric (T, U) bucket bounds, largest bucket = (max_frames, max_labels)."""
    out = []
    for i in range(num_buckets, 0, -1):
        f = 2.0 ** (i - num_buckets)
        out.append(
            (max(1, math.ceil(max_frames * f)), max(1, math.ceil(max_labels * f)))
        )
    return sorted(set(out))


def bucket_for(xn: int, yn: int, buckets: Sequence[Tuple[int, int]]):
    """Smallest bucket that fits (xn, yn); buckets must be sorted."""
    for b in buckets:
        if xn <= b[0] and yn <= b[1]:
            return b
    raise ValueError(f"({xn}, {yn}) exceeds the largest bucket {buckets[-1]}")


def pad_batch(features, labels, bucket: Tuple[int, int], pad_value=0.0):
    """Pad a list of (T_i, F) feature arrays and label sequences to a bucket.

    Returns (feats (N, T, F), labels (N, U), xn, yn) int32 lengths.
    """
    T, U = bucket
    N = len(features)
    F = features[0].shape[-1]
    feats = np.full((N, T, F), pad_value, np.float32)
    ys = np.zeros((N, U), np.int32)
    xn = np.zeros((N,), np.int32)
    yn = np.zeros((N,), np.int32)
    for i, (f, y) in enumerate(zip(features, labels)):
        t, u = f.shape[0], len(y)
        if t > T or u > U:
            raise ValueError(f"sample {i} ({t},{u}) exceeds bucket {bucket}")
        feats[i, :t] = f
        ys[i, :u] = y
        xn[i], yn[i] = t, u
    return feats, ys, xn, yn


def pack_padded_to_compact(xs, xn, yn):
    """Padded (N, T, U, V) log-probs -> compact (STU, V) (NumPy twin of
    `csrc` `rnnt_pack_compact_f32`)."""
    N, T, U, V = xs.shape
    return np.concatenate(
        [xs[i, : xn[i], : yn[i] + 1].reshape(-1, V) for i in range(N)], axis=0
    )


def pack_labels_to_compact(ys, yn):
    """Padded (N, U-1) labels -> compact (sum(yn),)."""
    return np.concatenate([ys[i, : yn[i]] for i in range(ys.shape[0])], axis=0)


def unpack_compact_to_padded(xs_compact, xn, yn, T=None, U=None, fill=0.0):
    """Compact (STU, V) -> padded (N, T, U, V)."""
    N = len(xn)
    T = T or int(np.max(xn))
    U = U or int(np.max(yn)) + 1
    V = xs_compact.shape[-1]
    out = np.full((N, T, U, V), fill, xs_compact.dtype)
    r = 0
    for i in range(N):
        rows = int(xn[i]) * (int(yn[i]) + 1)
        out[i, : xn[i], : yn[i] + 1] = xs_compact[r : r + rows].reshape(
            int(xn[i]), int(yn[i]) + 1, V
        )
        r += rows
    return out
