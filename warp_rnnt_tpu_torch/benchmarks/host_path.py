"""Where the host's time goes in one eager loss+grad call on a CUDA device:
the Python path that a compiled step (`utils.compiled_step`) replaces.

`breakdown(N, T, L, V)` takes `bench_loss.make_batch`'s inputs (N, T,
L labels, V) and reads `timing.bench_host` (host us a call; the calls
queue behind a device-side sleep, so none waits for the device) of:

  * "step": the eager loss+grad, `rnnt_loss(..., reduction="mean",
    gather=True)` then ``backward()``;
  * "forward": the same call on a leaf that requires grad, no backward;
  * "validation": `loss._validate_tensors` and the labels' shape check;
  * "labels_ext": `loss._labels_ext` (a fill and a cat);
  * "gather": `gather_kernels.gather_lattice` (one launch);
  * "sweep_epilogue": `cuda_impl.forward_backward_gathered` (the lattice
    and the epilogue, their outputs' allocations);
  * "mean": the mean of the (N,) costs;
  * "write": `flat_kernels.flat_grad_write` on the fp32 cotangent's two
    channels (one launch);
  * "cotangent_multiply": the core's backward, ``grads * ct``;
  * "compiled" (with ``compiled``, in a tree with `utils.compiled_step`):
    one replay of the same loss+grad compiled with its log-probs donated.

and derives "backward" = step - forward (the engine's walk and the
backward's launches), "tape" = forward - (validation + labels_ext +
gather + sweep_epilogue + mean) (the two autograd Functions' apply and
contexts, and what the loss does between its pieces), and "engine" =
backward - (write + cotangent_multiply) (the hand-off to the engine's
thread, the seed, the mean's backward, the gradient's accumulation).  A
derived part is a difference of two readings and carries both their
noise.  Then `torch.profiler`'s host side (CPU activity only) over
`PROFILED` eager calls gives each op's self host us a call, largest
first: the part of the path that runs as ops; the rest is Python.

Apart from "compiled" it reads only entry points that older trees have,
so `main_path_turns` (``--only host``) run in an older tree's copy times
that tree's path.  Needs a CUDA device.
"""

from __future__ import annotations

import torch

PROFILED = 20
STEP_CALLS = 50  # ten launches a call: well under the launch queue
PART_CALLS = 100


def _parts(xs, ys, xn, yn):
    """{part: (fn, args, calls)} for `timing.bench_host`."""
    from warp_rnnt_tpu_torch import rnnt_loss
    from warp_rnnt_tpu_torch.functional import loss as loss_mod
    from warp_rnnt_tpu_torch.ops import cuda_impl, flat_kernels, gather_kernels

    N, T, U, V = xs.shape

    def step(x):
        x = x.detach().requires_grad_()
        rnnt_loss(x, ys, xn, yn, reduction="mean", gather=True).backward()
        return x.grad

    def forward(x):
        return rnnt_loss(x, ys, xn, yn, reduction="mean", gather=True)

    def validation(x):
        loss_mod._validate_tensors(x, ys, xn, yn, 0)
        if tuple(ys.shape) != (N, U - 1):
            raise ValueError("labels' shape")

    loc = loss_mod._labels_ext(ys, 0)
    lat = gather_kernels.gather_lattice(xs, loc, 0)
    costs = cuda_impl.forward_backward_gathered(lat, xn, yn, 0.0)[0]
    grads = torch.empty_like(lat)
    ct = torch.rand(N, T, U, 2, device=xs.device)
    ct_n = torch.rand(N, device=xs.device)
    x_req = xs.detach().requires_grad_()
    return {
        "step": (step, (xs,), STEP_CALLS),
        "forward": (lambda: forward(x_req), (), PART_CALLS),
        "validation": (validation, (xs,), PART_CALLS),
        "labels_ext": (loss_mod._labels_ext, (ys, 0), PART_CALLS),
        "gather": (gather_kernels.gather_lattice, (xs, loc, 0),
                   PART_CALLS),
        "sweep_epilogue": (cuda_impl.forward_backward_gathered,
                           (lat, xn, yn, 0.0), PART_CALLS),
        "mean": (torch.mean, (costs,), PART_CALLS),
        "write": (lambda: flat_kernels.flat_grad_write(
            ct[..., 0], ct[..., 1], loc, 0, V, U * V), (), PART_CALLS),
        "cotangent_multiply": (lambda: grads * ct_n[:, None, None, None],
                               (), PART_CALLS),
    }


def _compiled_step(xs, ys, xn, yn):
    """(call, release) of the compiled, donated loss+grad on its own static
    log-probs, or None in a tree without `utils.compiled_step`."""
    try:
        from warp_rnnt_tpu_torch.utils import compiled_step  # noqa: F401
    except ImportError:
        return None
    from warp_rnnt_tpu_torch.benchmarks import bench_loss

    step = bench_loss.loss_grad_step(ys, xn, yn)
    x = step(xs)[1]  # captures; x is its static log-probs' buffer
    return (lambda: step(x)), step.release


def host_profile(fn, calls=PROFILED):
    """[(self host us a call, calls a call, op)] of ``calls`` calls of
    ``fn()`` under `torch.profiler`'s host side, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.self_cpu_time_total / calls, ev.count / calls, ev.key)
            for ev in prof.key_averages() if ev.self_cpu_time_total > 0]
    return sorted(rows, reverse=True)


def breakdown(N, T, L, V, seed=0, compiled=True):
    """The host path of one eager loss+grad at (N, T, L labels, V): {"us":
    {part: host us a call}, "ops": `host_profile` of the step}."""
    from warp_rnnt_tpu_torch.benchmarks import timing
    from warp_rnnt_tpu_torch.benchmarks.bench_loss import make_batch

    if not torch.cuda.is_available():
        raise SystemExit("host_path needs a CUDA device")
    xs, ys, xn, yn = make_batch(seed, N, T, L, V)
    parts = _parts(xs, ys, xn, yn)
    us = {name: timing.bench_host(fn, args, calls=calls)
          for name, (fn, args, calls) in parts.items()}
    us["backward"] = us["step"] - us["forward"]
    us["tape"] = us["forward"] - sum(us[k] for k in (
        "validation", "labels_ext", "gather", "sweep_epilogue", "mean"))
    us["engine"] = us["backward"] - us["write"] - us["cotangent_multiply"]
    replay = _compiled_step(xs, ys, xn, yn) if compiled else None
    if replay is not None:
        call, release = replay
        try:
            us["compiled"] = timing.bench_host(call, (), calls=STEP_CALLS)
        finally:
            release()
    step = parts["step"][0]
    ops = host_profile(lambda: step(xs))
    return {"us": us, "ops": [(round(u, 2), round(c, 2), key[:70])
                              for u, c, key in ops[:16]]}
