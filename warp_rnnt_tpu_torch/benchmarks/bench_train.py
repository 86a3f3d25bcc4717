"""End-to-end transducer training step on a CUDA device (counterpart of
`warp_rnnt_tpu/benchmarks/bench_train.py`).

Times the full train step (encoder, predictor, joint, RNN-T loss, backward
and the AdamW update) at the JAX benchmark's shapes, with its arguments
and JSON keys.  The optimizer is ``torch.optim.AdamW(lr=1e-3,
weight_decay=1e-4)``, the update of ``optax.adamw(1e-3)``.  Each step
updates the parameters in place and the next reads them, so a chain of
steps is dependency-forced; its time is the two-point marginal of
`timing.bench_grad_chain` on CUDA events.  Beside it: the peak device
memory of a step, and under the profiler (`profile_loss.profile_step`)
the kernels a step, the device's busy ms, its idle share and the
kernels that take the most device ms a step; and the step's bound
(`train_bound`), from `timing.card_rates`.

As JAX times ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``,
the step is timed compiled by default: `models.compiled_train_step`, the
whole step one CUDA graph a shape, its AdamW built with
``capturable=True`` (the step count on the device), each call fed the
graph's own static batch, as a jitted step reads its arguments in place.
The eager step (`make_train_step`, its AdamW as before, so its reading is
the one earlier trees gave) is timed beside it on a fresh model from the
same seed, under ``"eager"``; ``--eager`` times the eager step alone.

Usage: python -m warp_rnnt_tpu_torch.benchmarks.bench_train [N] [T] [U] [V]
                                                            [loss_mode]
                                                            [--eager]
Prints one JSON line.  Needs a CUDA device; the CLI turns TF32 off in
cuBLAS and cuDNN, so the fp32 GRU runs in fp32, as `chip_smoke.py` does.
"""

from __future__ import annotations

import json
import sys

import torch

from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
from warp_rnnt_tpu_torch.models import init_model, make_train_step
from warp_rnnt_tpu_torch.models.transducer import compiled_train_step

BLOCKS, KERNEL = 2, 5  # the encoder's conv blocks and their width
TOP = 12  # kernels printed by device time a step


def valid_cells(xn, yn):
    """The lattice cells the loss reads: sum(xn * (yn + 1))."""
    return int((xn.long() * (yn.long() + 1)).sum())


def train_work(N, T, U, V, feat_dim, hidden, R, loss_mode, n_params):
    """(bf16 tensor-core operations, fp32 operations, bytes) that one train
    step's formulation needs on R valid cells (`valid_cells`).

    Operations: each product forward and twice backward (the input layer
    once: its input needs no gradient), on the valid cells for the joint.
    "from_logits" and "gather" run the joint's two dense layers on every
    cell (6 R H (H + V)); "fused" runs the pre-projections on frames and
    labels only and four R H V products in the fused kernels (the forward,
    and the backward's recomputed logits, d_h and d_W).  The conv blocks
    and the dense layers are bf16; the GRU is fp32.
    Bytes: the parameters read, their gradients written, AdamW's reads of
    parameter, gradient and two moments and writes of three (36 bytes a
    parameter), the features; and for the padded modes the fp32 logits of
    the valid cells written, read and their gradient written (12 R V)."""
    H = hidden
    frames = N * T
    enc = (2 * 2 * frames * feat_dim * H
           + 3 * BLOCKS * 2 * frames * KERNEL * H * 2 * H)
    gru = 3 * 2 * N * U * (3 * H * H) * 2
    if loss_mode == "fused":
        joint = 3 * 2 * (N * T + N * U) * H * H + 4 * 2 * R * H * V
        logits_bytes = 0
    else:
        joint = 3 * 2 * R * H * (H + V)
        logits_bytes = 3 * R * V * 4
    nbytes = 36 * n_params + frames * feat_dim * 4 + logits_bytes
    return enc + joint, gru, nbytes


def train_bound(work, rates):
    """(ms, "bytes" | "operations") of `train_work` on a card of ``rates``
    (`timing.card_rates`): the larger of the bytes over the memory rate and
    the operations, each type over its own peak, summed."""
    bf16_ops, fp32_ops, nbytes = work
    t_ops = (bf16_ops / rates[2] + fp32_ops / rates[1]) * 1e3
    t_bytes = nbytes / rates[0] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _readings(step, batch, steps, warmup):
    """(chained ms, peak bytes of one step, `profile_step` of a step, the
    last loss) of ``step(batch)``."""
    for _ in range(warmup):
        loss = step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = timing.bench_grad_chain(lambda _: (None, step(batch)), loss, steps,
                                 warmup=0)
    prof = profile_step(lambda: step(batch))
    return ms, peak, prof, step(batch)


def bench_train(N=32, T=400, U=40, V=1024, feat_dim=80, hidden=512,
                steps=20, warmup=3, loss_mode="from_logits", compiled=True):
    """The step's numbers as a dict (the JAX benchmark's keys, then
    peak_mb, kernels_per_step, busy_ms, idle_share, bound_ms, bound_by,
    valid_cells, kernels: [device ms a step, launches a step, name] of
    every kernel, the most device time first, device; then compiled,
    capture_ms and pool_mib, and with ``compiled`` "eager": the eager
    step's step_ms, utts_per_s, loss, peak_mb, kernels_per_step, busy_ms,
    idle_share and kernels).  Compiled, the step keys read the graph's
    replays.  The model and batch come from `init_model`'s seed 0, as the
    JAX benchmark's from its key 0."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_train needs a CUDA device")

    def model_and_batch():
        return init_model(
            0, vocab_size=V, feat_dim=feat_dim, N=N, T=T, U=U,
            device="cuda", encoder_hidden=hidden, predictor_hidden=hidden,
            joint_hidden=hidden)

    def keys(ms, peak, prof, loss):
        return {"step_ms": ms, "utts_per_s": N / (ms / 1000.0),
                "loss": float(loss), "peak_mb": peak / 2**20,
                "kernels_per_step": prof["kernels_per_call"],
                "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
                "kernels": [[t, count, name[:80]]
                            for t, count, name in prof["rows"]]}

    model, params, batch = model_and_batch()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    eager = keys(*_readings(make_train_step(model, opt, loss_mode=loss_mode),
                            batch, steps, warmup))
    extra = {"compiled": False, "capture_ms": None, "pool_mib": None}
    if compiled:
        del model, params, opt
        torch.cuda.empty_cache()
        model, params, batch = model_and_batch()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-4, capturable=True)
        step = compiled_train_step(model, opt, loss_mode=loss_mode)
        step(batch)  # captures
        entry = step.compiled.entry
        try:
            out = keys(*_readings(step, entry.args, steps, warmup))
        finally:
            step.compiled.release()
        extra = {"compiled": True, "capture_ms": entry.capture_ms,
                 "pool_mib": entry.pool_bytes / 2**20, "eager": eager}
    else:
        out = eager

    n_params = sum(p.numel() for p in params.values())
    rates = timing.card_rates()
    R = valid_cells(*batch[2:])
    bound, bound_by = train_bound(
        train_work(N, T, U, V, feat_dim, hidden, R, loss_mode, n_params), rates)
    return {
        "N": N, "T": T, "U": U, "V": V, "hidden": hidden,
        "loss_mode": loss_mode,
        "params_m": round(n_params / 1e6, 2),
        **{k: out[k] for k in ("step_ms", "utts_per_s", "loss", "peak_mb",
                               "kernels_per_step", "busy_ms", "idle_share")},
        "bound_ms": bound, "bound_by": bound_by, "valid_cells": R,
        "kernels": out["kernels"],
        "device": torch.cuda.get_device_name(0),
        **extra,
    }


def main(*args):
    compiled = "--eager" not in args
    args = [a for a in args if a != "--eager"]
    loss_mode = "from_logits"
    if args and args[-1] in ("from_logits", "gather", "fused"):
        loss_mode, args = args[-1], args[:-1]
    cfg = [int(a) for a in args] or [32, 400, 40, 1024]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = bench_train(*cfg, loss_mode=loss_mode, compiled=compiled)
    r["kernels"] = r["kernels"][:TOP]
    if compiled:
        r["eager"]["kernels"] = r["eager"]["kernels"][:TOP]
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
