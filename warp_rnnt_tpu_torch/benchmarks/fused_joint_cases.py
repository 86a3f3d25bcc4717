"""The fused joint kernels against their plain versions: the cases and the
one comparison, shared by `chip_smoke.py` and the `cuda`-marked tests.

Forward: blank logit, label logit and logZ agree at atol 1e-4 on frames
t < xn (fp32 sums in another order), and every cell is finite.

Backward: each output agrees within 1e-3 of its largest plain entry (sums
over V and over rows in another order).  d_W and d_b are held column group
by column group: the blank column, the label columns, and the other
columns, each against its own largest entry.  At a realistic V nearly every
column is an other column, reached only by the softmax term of dz, and its
entries are orders of magnitude below the blank column's: held against one
largest entry over all columns, a kernel that dropped that term, or read
the wrong logZ, would pass.
"""

from __future__ import annotations

import numpy as np
import torch

FWD_ATOL = 1e-4
BWD_RTOL = 1e-3
GROUPS = ("blank", "label", "other")

# name: (seed, N, T, U, V, H, blank, xn).  xn=2 is shorter than one 64-row
# tile (7 frames at U=9); V=200, V=130 and V=320 are not multiples of the
# backward's 128-column chunk (V=320: an odd count of 64-column blocks);
# U=70 and U=65 span more than one tile per frame, U=129 more than one
# backward block (128 rows); H=256 is the kernels' slice width, H=272
# one step of 16 above it (two slices); R=6 is less than one tile; xn=1
# leaves one live frame.  The forward's V edges: V=64 is one chunk; V=65
# two, the second holding one column (the blank), each its own V part (two
# tiles, one block); V=1025 at two tiles splits V into 17 one-chunk parts,
# the last holding one column (the blank).
KERNEL_CASES = {
    "ragged": (20, 3, 37, 9, 200, 32, 0, (37, 2, 20)),
    "U>32 blank=3": (21, 2, 19, 37, 64, 16, 3, (19, 11)),
    "U>64": (22, 2, 7, 70, 130, 48, 0, (7, 3)),
    "H=512": (23, 2, 13, 5, 5000, 512, 3, (13, 9)),
    "U=65 V=320": (40, 2, 5, 65, 320, 64, 0, (5, 2)),
    "U=129 xn=1": (41, 2, 4, 129, 130, 128, 5, (4, 1)),
    "H=256": (42, 2, 9, 21, 1000, 256, 0, (9, 4)),
    "H=272 xn=1": (43, 2, 9, 21, 1000, 272, 7, (9, 1)),
    "R<64": (44, 1, 2, 3, 77, 32, 0, (2,)),
    "V=64": (46, 2, 9, 5, 64, 32, 0, (9, 4)),
    "V=65": (47, 2, 9, 5, 65, 32, 64, (9, 7)),
    "V=1025 parts": (45, 1, 20, 6, 1025, 64, 1024, (17,)),
}

# Widths the kernels pad (H not a multiple of 64) or slice (H > 256), and
# more samples than a grid's y dimension holds (N > 65535).
WIDE_CASES = {
    "H=40": (27, 2, 13, 5, 300, 40, 3, (13, 9)),
    "H=200": (28, 2, 13, 5, 300, 200, 0, (13, 6)),
    "H=640": (29, 2, 13, 5, 300, 640, 3, (13, 9)),
    "H=1024 U>64": (30, 2, 5, 70, 130, 1024, 0, (5, 3)),
    "H=2048": (31, 2, 50, 11, 1000, 2048, 0, (50, 33)),
    "N=65537": (32, 65537, 1, 2, 64, 16, 0, (1,) * 65537),
}

# LLM-size vocabularies, where the JAX package takes its V-blocked kernels:
# V=64000, and GPT-2's V=50257 (not a multiple of the 64-column chunk).
LARGE_V_CASES = {
    "V=64000": (25, 1, 20, 6, 64000, 256, 0, (20,)),
    "V=50257": (26, 1, 17, 5, 50257, 256, 0, (11,)),
}


def kernel_case(seed, N, T, U, V, H, blank, xn, device="cuda"):
    """Seeded kernel operands (a, c, w, b, labels_ext, xn, yn) and lattice
    cotangents (db, de), zero at frames t >= xn, on ``device``.  Labels are
    drawn from [0, V), so some equal the blank; the last row's is the
    blank."""
    rng = np.random.RandomState(seed)
    a = 0.3 * rng.randn(N, T, H)
    c = 0.3 * rng.randn(N, U, H)
    w = 0.2 * rng.randn(H, V)
    b = 0.1 * rng.randn(V)
    lab = rng.randint(0, V, (N, U))
    lab[:, -1] = blank
    xn = np.asarray(xn)
    live = (np.arange(T)[None, :] < xn[:, None])[..., None]
    db = rng.randn(N, T, U) * live
    de = rng.randn(N, T, U) * live

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    ops = (f32(a), f32(c), f32(w), f32(b), i32(lab), i32(xn),
           i32(np.full(N, U - 1)))
    return ops, (f32(db), f32(de))


def column_groups(labels, blank, V):
    """(V,) group index of each column: 0 the blank, 1 a label, 2 other."""
    ids = torch.full((V,), 2, dtype=torch.long, device=labels.device)
    ids[labels.long().flatten()] = 1
    ids[blank] = 0
    return ids


def check_close(name, got, want, rtol, groups=None):
    """Hold ``got`` against ``want`` within ``rtol`` of the largest |want|,
    over the whole tensor or, with ``groups`` (a `column_groups` result),
    per column group of the last axis.  Raises AssertionError.  Returns
    {group: (max abs err, max |want|)}."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} !="
                             f" {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    parts = ({"all": (got, want)} if groups is None else
             {g: (got[..., groups == i], want[..., groups == i])
              for i, g in enumerate(GROUPS) if bool((groups == i).any())})
    readings = {}
    for group, (k, p) in parts.items():
        err, scale = float((k - p).abs().max()), float(p.abs().max())
        readings[group] = (err, scale)
        if err > rtol * scale:
            raise AssertionError(
                f"{name} ({group} columns): max abs err {err} > {rtol} x"
                f" max |ref| {scale}"
            )
    return readings


def check_forward(got, want, xn):
    """Forward outputs against the plain version: atol 1e-4 on frames
    t < xn, finite everywhere.  Returns the max abs err."""
    live = (torch.arange(want[0].shape[1], device=xn.device)[None, :]
            < xn[:, None])[..., None].expand_as(want[0])
    err = 0.0
    for name, k, p in zip(("blank_logit", "emit_logit", "logZ"), got, want):
        if not torch.isfinite(k).all():
            raise AssertionError(f"fused_joint_fwd {name}: non-finite cell")
        diff = float((k - p)[live].abs().max())
        if diff > FWD_ATOL:
            raise AssertionError(f"fused_joint_fwd {name}: max abs err {diff}")
        err = max(err, diff)
    return err


def check_backward(got, want, labels_ext, blank):
    """(d_a, d_c, d_w, d_b) against the plain version, `check_close` at
    rtol 1e-3; d_w and d_b per column group.  Returns {kernel: {output:
    readings}}."""
    groups = column_groups(labels_ext, blank, want[3].shape[0])
    out = {}
    for kernel, names, idx in (("fused_joint_bwd_dadc", ("d_a", "d_c"), (0, 1)),
                               ("fused_joint_bwd_dwdb", ("d_w", "d_b"), (2, 3))):
        out[kernel] = {
            n: check_close(f"{kernel} {n}", got[i], want[i], BWD_RTOL,
                           groups if kernel.endswith("dwdb") else None)
            for n, i in zip(names, idx)
        }
    return out


def compare(fj, ops, cot, blank):
    """Run the forward and backward kernels (through `fj`, the module
    `warp_rnnt_tpu_torch.ops.fused_joint`) and their plain versions on the
    same operands, and hold them together.  The backward takes the plain
    forward's logZ.  Returns {kernel: readings}; raises AssertionError."""
    db, de = cot
    xn = ops[5]
    fwd_p = fj.joint_lattice_fwd_plain(*ops, blank)
    readings = {"fused_joint_fwd": check_forward(
        fj.joint_lattice_fwd(*ops, blank), fwd_p, xn)}
    args = (*ops, fwd_p[2], db, de, blank)
    readings.update(check_backward(fj.joint_lattice_bwd(*args),
                                   fj.joint_lattice_bwd_plain(*args),
                                   ops[4], blank))
    return readings


def max_err(readings):
    """The largest abs err in a reading (a number, or nested dicts of
    (err, scale) pairs)."""
    if isinstance(readings, dict):
        return max(max_err(r) for r in readings.values())
    return readings[0] if isinstance(readings, tuple) else readings
