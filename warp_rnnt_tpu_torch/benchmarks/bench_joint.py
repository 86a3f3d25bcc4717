"""Joint network + loss training step on a CUDA device, five ways
(counterpart of `warp_rnnt_tpu/benchmarks/bench_joint.py`, itself
warp-rnnt's `pytorch_binding/benchmark2.py`).

    python -m warp_rnnt_tpu_torch.benchmarks.bench_joint [mode [N T U V [H]]]
                                                        [--rand-length]
                                                        [--eager]

One step is the Tanh-MLP joint (`models.Joint`: bf16 products, fp32
log_softmax), the RNN-T loss (reduction "mean") and the gradients with
respect to the joint's four parameters; f and g carry no gradient, as in
the JAX module's ``jax.value_and_grad(loss_fn)`` (argument 0).  Modes:

  * "log_softmax+gather": the joint's log-probs, `rnnt_loss(gather=True)`;
  * "from_logits": the joint's raw logits, `rnnt_loss_from_logits`;
  * "compact": the joint on the sum(xn * (yn + 1)) valid cells only, packed
    rows, `rnnt_loss(compact=True)`;
  * "fused": `rnnt_loss_fused_joint` on the joint's own weights; the
    (N, T, U+1, V) logits never exist;
  * "auto": `rnnt_loss_joint(layout="auto")`, whose route
    (`joint_layout_route`) each result names.

As JAX times ``jax.jit(value_and_grad)``, the step is timed compiled by
default (`compiled_joint_step`: `utils.compiled_step`, one CUDA graph a
shape); ``--eager`` times it eagerly.  "compact" compiles as JAX's does:
its rows are packed from the lengths read once, outside the step (`pack`),
and the loss takes the static bounds ``max_frames=T, max_labels=U``, so
the step reads nothing on the host.

The weights come from a seeded numpy tree in Flax's layout and
initializers (`joint_tree`: lecun-normal kernels, zero biases), carried in
with `models.carry_flax_joint`; f, g and the labels from a
`torch.Generator`, the labels all 1 as in the JAX module; random lengths
from ``np.random.RandomState(0)``, drawn as the JAX module draws them, so
the two give the same lengths.  Each mode prints one JSON line with the
JAX module's keys (``step_ms``, the dependency-forced chain of
`timing.bench_scalar_chain`, compiled with the scalar fold where the step
is; ``peak_hbm_mb``, `utils.profiling.peak_memory_mb` of an eager call,
measured), then whether the step was compiled (with the graph's capture ms
and pool MiB), the step's kernels a call (a replay where compiled), device
busy ms and idle share under the profiler (`profile_loss.profile_step`),
and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from warp_rnnt_tpu_torch import (rnnt_loss, rnnt_loss_from_logits,
                                 rnnt_loss_fused_joint, rnnt_loss_joint)
from warp_rnnt_tpu_torch.functional.joint_loss import joint_layout_route
from warp_rnnt_tpu_torch.models.joint import carry_flax_joint
from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

MODES = ("log_softmax+gather", "from_logits", "compact", "fused", "auto")
# The JAX module's full width (its bench_joint's defaults): 20 labels.
DEFAULTS = dict(N=16, T=150, U=20, V=5000, H=256)


def lecun_normal(rng, fan_in, fan_out):
    """Flax's default kernel: a normal truncated to two standard
    deviations, scaled to variance 1 / fan_in."""
    x = rng.standard_normal((fan_in, fan_out))
    out = np.abs(x) > 2
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2
    return (x * (fan_in ** -0.5 / 0.87962566103423978)).astype(np.float32)


def joint_tree(seed, H, V):
    """The Flax `Joint(vocab_size=V, hidden=H)` tree on H-wide inputs,
    {"params": {"pre", "out"}}, numpy arrays from a seed."""
    rng = np.random.RandomState(seed)
    return {"params": {
        layer: {"kernel": lecun_normal(rng, H, width),
                "bias": np.zeros(width, np.float32)}
        for layer, width in (("pre", H), ("out", V))}}


def make_inputs(seed, N, T, U, H, rand_length=False, device="cuda"):
    """f (N, T, H), g (N, U+1, H) normal, labels (N, U) all 1, lengths full
    or random (xn in [T//2, T], then yn in [U//2, U], from
    ``np.random.RandomState(0)``); int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn(N, T, H, generator=gen, device=device)
    g = torch.randn(N, U + 1, H, generator=gen, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    ys = torch.randint(1, 2, (N, U), generator=gen, **i32)
    if rand_length:
        rng = np.random.RandomState(0)
        xn = torch.tensor(rng.randint(T // 2, T + 1, size=N), **i32)
        yn = torch.tensor(rng.randint(U // 2, U + 1, size=N), **i32)
    else:
        xn = torch.full((N,), T, **i32)
        yn = torch.full((N,), U, **i32)
    return f, g, ys, xn, yn


def compact_indices(xn, yn):
    """(n_idx, t_idx, u_idx) int32 numpy arrays of the packed rows, one per
    valid cell, sample by sample, frame by frame (the JAX module's
    construction)."""
    xn_h, yn_h = np.asarray(xn), np.asarray(yn)
    n_idx = np.concatenate([np.full(t * (u + 1), i, np.int32)
                            for i, (t, u) in enumerate(zip(xn_h, yn_h))])
    t_idx = np.concatenate([np.repeat(np.arange(t, dtype=np.int32), u + 1)
                            for t, u in zip(xn_h, yn_h)])
    u_idx = np.concatenate([np.tile(np.arange(u + 1, dtype=np.int32), t)
                            for t, u in zip(xn_h, yn_h)])
    return n_idx, t_idx, u_idx


def pack(ys, xn, yn, T, U):
    """The compact mode's packing, read from the lengths on the host once:
    (n_idx, t_idx, u_idx) int64 tensors on the labels' device, the packed
    labels (sum(yn),), and the lattice bounds T, U."""
    xn_h, yn_h = xn.cpu().numpy(), yn.cpu().numpy()
    idx = [torch.from_numpy(a).long().to(ys.device)
           for a in compact_indices(xn_h, yn_h)]
    ys_packed = torch.cat([ys[i, :yn_h[i]] for i in range(len(yn_h))])
    return (*idx, ys_packed, T, U)


def fused_params(joint):
    """The joint's own weights as the fused loss's (in, out) views."""
    return {"w_pre": joint.pre.weight.t(), "b_pre": joint.pre.bias,
            "w_out": joint.out.weight.t(), "b_out": joint.out.bias}


def joint_loss_fn(mode, joint, f, g, ys, xn, yn, packed=None):
    """The mean loss of one step in ``mode`` (see the module docstring);
    ``packed`` is `pack`'s tuple, for "compact"."""
    if mode == "log_softmax+gather":
        return rnnt_loss(joint(f, g), ys, xn, yn, reduction="mean",
                         gather=True)
    if mode == "from_logits":
        return rnnt_loss_from_logits(joint(f, g, normalize=False), ys, xn, yn,
                                     reduction="mean")
    if mode == "compact":
        n_idx, t_idx, u_idx, ys_packed, T, U = packed
        lp = joint(f[n_idx, t_idx], g[n_idx, u_idx])  # (rows, V)
        return rnnt_loss(lp, ys_packed, xn, yn, reduction="mean", compact=True,
                         max_frames=T, max_labels=U)
    if mode == "fused":
        return rnnt_loss_fused_joint(f, g, fused_params(joint), ys, xn, yn,
                                     reduction="mean")
    if mode == "auto":
        return rnnt_loss_joint(f, g, fused_params(joint), ys, xn, yn,
                               reduction="mean", layout="auto")
    raise ValueError(f"unknown mode: {mode!r}")


def joint_params(joint):
    """The four parameters the step differentiates, in the Flax tree's
    order: pre kernel, pre bias, out kernel, out bias."""
    return (joint.pre.weight, joint.pre.bias, joint.out.weight, joint.out.bias)


def grad_tree(gw_pre, gb_pre, gw_out, gb_out):
    """The four gradients of `joint_params` as a Flax tree {"pre", "out"}
    of {"kernel" (in, out), "bias"}."""
    return {"pre": {"kernel": gw_pre.t(), "bias": gb_pre},
            "out": {"kernel": gw_out.t(), "bias": gb_out}}


def value_and_grad(mode, joint, f, g, ys, xn, yn, packed=None):
    """(loss, `grad_tree` of the gradients) of one step in ``mode``."""
    loss, *grads = loss_grad_fn(mode, joint, ys, xn, yn, packed)(f, g)
    return loss, grad_tree(*grads)


def route(mode, f, V, H):
    """The layout a mode runs: "auto" names `joint_layout_route`'s answer
    for the tensors' device."""
    if mode != "auto":
        return mode
    N, T, _ = f.shape
    return joint_layout_route(T, 0, H, V, N, platform=f.device.type)


def loss_grad_fn(mode, joint, ys, xn, yn, packed=None):
    """(f, g) -> (loss, the gradients of the four `joint_params`) of one
    step in ``mode``: the function `compiled_joint_step` compiles."""
    params = joint_params(joint)

    def step(f, g):
        loss = joint_loss_fn(mode, joint, f, g, ys, xn, yn, packed)
        return (loss.detach(), *torch.autograd.grad(loss, params))

    return step


def step_key(mode, joint, f, ys, xn, yn, packed=None):
    """The compiled step's key: the mode, its route, and the addresses of
    what `loss_grad_fn` closes over (the four parameters, the labels, the
    lengths, and `pack`'s tensors and bounds)."""
    V, H = joint.out.out_features, joint.pre.out_features
    extra = () if packed is None else (
        *(t.data_ptr() for t in packed[:4]), *packed[4:])
    return ("bench_joint", mode, route(mode, f, V, H),
            *(p.data_ptr() for p in joint_params(joint)),
            ys.data_ptr(), xn.data_ptr(), yn.data_ptr(), *extra)


def compiled_joint_step(mode, joint, f, ys, xn, yn, packed=None):
    """`loss_grad_fn` of ``mode`` compiled once a shape (`utils.
    compiled_step`): ``step(f, g)`` -> (loss, 4 gradients), on the card the
    graph's static tensors.  ``f`` gives the route's device.  "compact"
    takes `pack`'s tuple, or packs here (its one host read, outside the
    step)."""
    if mode == "compact" and packed is None:
        packed = pack(ys, xn, yn, f.shape[1], ys.shape[1])
    return compiled_step(loss_grad_fn(mode, joint, ys, xn, yn, packed),
                         key=step_key(mode, joint, f, ys, xn, yn, packed))


def bench_joint(N=16, T=150, U=20, V=5000, H=256, mode="from_logits",
                rand_length=False, seed=0, iters=20, compiled=True):
    """One mode's step on the card: the JAX module's keys, then compiled,
    capture_ms, pool_mib, kernels_per_call, busy_ms, idle_share,
    profile_complete (from `profile_loss.device_profile`, of replays where
    compiled), route, device, power_limit."""
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
    from warp_rnnt_tpu_torch.benchmarks.timing import bench_scalar_chain
    from warp_rnnt_tpu_torch.utils.profiling import card, peak_memory_mb

    if not torch.cuda.is_available():
        raise SystemExit("bench_joint needs a CUDA device")
    f, g, ys, xn, yn = make_inputs(seed, N, T, U, H, rand_length)
    joint, _ = carry_flax_joint(joint_tree(seed + 1, H, V), device="cuda")
    packed = pack(ys, xn, yn, T, U) if mode == "compact" else None
    step = loss_grad_fn(mode, joint, ys, xn, yn, packed)
    out = {"mode": mode, "N": N, "T": T, "U": U, "V": V, "H": H,
           "rand_length": bool(rand_length)}
    if compiled:
        key = step_key(mode, joint, f, ys, xn, yn, packed)
        out["step_ms"] = bench_scalar_chain(step, (f, g), iters, key=key)
        cstep = compiled_joint_step(mode, joint, f, ys, xn, yn, packed)
        try:
            cstep(f, g)  # captures
            static = cstep.entry.args
            prof = profile_step(lambda: cstep(*static))
            extra = {"capture_ms": cstep.entry.capture_ms,
                     "pool_mib": cstep.entry.pool_bytes / 2**20}
        finally:
            cstep.release()
    else:
        out["step_ms"] = bench_scalar_chain(step, (f, g), iters)
        prof = profile_step(lambda: step(f, g))
        extra = {"capture_ms": None, "pool_mib": None}
    out.update({"peak_hbm_mb": peak_memory_mb(step, f, g),
                "compiled": compiled, **extra,
                "kernels_per_call": prof["kernels_per_call"],
                "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
                "profile_complete": prof["complete"],
                "route": route(mode, f, V, H), **card()})
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    mode = args[0] if args else None
    kw = dict(zip(("N", "T", "U", "V", "H"), (int(a) for a in args[1:])))
    rand_length = "--rand-length" in argv
    compiled = "--eager" not in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for m in (mode,) if mode else MODES:
        print(json.dumps(bench_joint(mode=m, rand_length=rand_length,
                                     compiled=compiled, **kw)), flush=True)


if __name__ == "__main__":
    main()
