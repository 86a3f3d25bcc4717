"""The compact layout's data movement and its loss+grad step on a CUDA
device, at the two full-width cases of `chip_smoke.py` (`profile_loss.CASES`
A: N=32, T=150, 20 labels, V=5000; B: N=16, T=1500, 300 labels, V=50;
random lengths, 13 pad rows).

    python -m warp_rnnt_tpu_torch.benchmarks.packed_step [--case A|B] [--tag x]

For each case it prints one JSON line:
  * "packed_gather": the forward movement, packed (rows, V) log-probs,
    labels and lengths -> the (N, T, U, 2) lattice the sweep reads;
    "packed_scatter": the backward movement, the lattice's cotangent -> the
    packed (rows, V) gradient.  Each: `movement_times`.  Beside the gather:
    its byte bound (`gather_bytes`) and its sector floors (`floors`), at
    the card's memory rate (`timing.card_rates`).
  * the compact loss+grad (`loss_grad_step`) chained ms and the no-grad
    costs' chained ms (`no_grad_ms`); under the profiler
    (`profile_loss.profile_step`) the kernels a call, device busy ms, idle
    share and the largest kernels.
  * compiled (the default; ``--eager`` leaves it out), as JAX jits the
    compact loss with static bounds: under ``"compiled"`` the loss+grad
    and the no-grad costs each one CUDA graph (`utils.compiled_step`),
    their static bounds ``max_frames``, ``max_labels`` the case's own,
    read once when the case was built, so the step reads nothing on the
    host.  Each is timed by `chain_ms`, compiled and eager with the same
    timer (`timing.bench_scalar_chain`: the loss folded into a scalar the
    next call carries; the gradient is not fed back, so no call copies
    its 1 GB), with the capture ms, the graph's pool MiB and a replay
    under the profiler.

`chip_smoke.py` times the movement and the step through these functions.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from warp_rnnt_tpu_torch import rnnt_loss
from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.packed_cases import full_case
from warp_rnnt_tpu_torch.benchmarks.profile_loss import CASES, profile_step
from warp_rnnt_tpu_torch.ops import packed_kernels as pk
from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

SEED = 0


def gather_bytes(case, granule=0):
    """Bytes the forward movement must move: the blank and label entries of
    every valid cell (``granule``: the distinct aligned ``granule``-byte
    blocks holding them, 32 for the L2's sectors, 64 for a fetch of two),
    the labels and lengths read, the (N, T, U, 2) fp32 lattice, loc and the
    prefix sums written."""
    xs, xn, yn = case["xs"], case["xn"], case["yn"]
    N, T, U, V = xn.shape[0], case["T"], case["U"], xs.shape[1]
    pos, valid = pk.lattice_rows(xn, yn, T, U)
    loc = pk.loc_rows(case["ys"], xn, yn, U, case["blank"]).long()
    rows = pos[valid]
    labels = loc[:, None, :].expand(N, T, U)[valid]
    size = xs.element_size()
    if granule:
        addr = torch.cat([rows * V + case["blank"], rows * V + labels]) * size
        read = torch.unique(addr // granule).numel() * granule
    else:
        read = 2 * rows.numel() * size
    return (read + case["ys"].numel() * 4 + 8 * N + N * T * U * 8
            + N * U * 4 + 16 * N)


def floors(case, hbm):
    """The gather's sector floors in ms at ``hbm`` bytes/s: its reads
    counted in 32-byte sectors and in 64-byte blocks on this case's
    lengths."""
    return {key: gather_bytes(case, granule) / hbm * 1e3
            for key, granule in (("sector_floor_ms", 32),
                                 ("fetch64_floor_ms", 64))}


def movement(case):
    """(fwd, bwd): the forward movement (`packed_gather_lattice`, its
    lattice) and the backward movement (`packed_scatter` of the case's
    cotangent on the forward's meta) as zero-argument calls."""
    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    blank, T, U = case["blank"], case["T"], case["U"]
    rows, V = xs.shape
    _, loc, pref = pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
    return (lambda: pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)[0],
            lambda: pk.packed_scatter(case["ct"], loc, pref, xn, yn, blank,
                                      rows, V, xs.dtype))


def movement_times(fn, x):
    """A zero-argument call's chained ms (`timing.bench_scalar_chain`),
    device ms (`timing.bench_graph`, CUDA graph, L2 flushed) and host us
    (`timing.bench_host`, 20 calls behind the sleep).  ``x``: a tensor for
    the timers to thread through."""
    call = lambda _: fn()  # noqa: E731  (the timers want a tensor argument)
    return {"ms": timing.bench_scalar_chain(
                call, (x,), 20, reduce_out=lambda out: out.view(-1)[0]),
            "device_ms": timing.bench_graph(call, (x,)),
            "host_us": timing.bench_host(call, (x,), calls=20)}


def bounds(case):
    """The case's static bounds, as ``rnnt_loss`` takes them:
    {"max_frames": max(xn), "max_labels": max(yn)}, read from the lengths
    once, when the case was built."""
    return {"max_frames": case["T"], "max_labels": case["U"] - 1}


def loss_grad_step(case, static=False):
    """The compact loss+grad, `rnnt_loss(..., compact=True,
    reduction="mean")` + backward, as `timing.bench_grad_chain` steps it:
    xs -> (loss, gradient).  ``static``: with the case's `bounds`, as the
    compiled step takes them."""
    ys, xn, yn = case["ys"], case["xn"], case["yn"]
    kw = bounds(case) if static else {}

    def step(x):
        x = x.detach().requires_grad_()
        loss = rnnt_loss(x, ys, xn, yn, compact=True, reduction="mean", **kw)
        loss.backward()
        return loss.detach(), x.grad

    return step


def costs_step(case, static=False):
    """xs -> (the compact costs without autograd,); ``static`` as in
    `loss_grad_step`."""
    ys, xn, yn = case["ys"], case["xn"], case["yn"]
    kw = bounds(case) if static else {}

    def costs(x):
        with torch.no_grad():
            return (rnnt_loss(x, ys, xn, yn, compact=True, **kw),)

    return costs


def step_key(case, grad):
    """A compiled step's key: what `loss_grad_step` and `costs_step` close
    over (the labels' and lengths' addresses, the bounds)."""
    return ("packed_step", grad, case["ys"].data_ptr(), case["xn"].data_ptr(),
            case["yn"].data_ptr(), *bounds(case).values())


def compiled_steps(case):
    """(loss+grad, costs) of the case compiled once a shape
    (`utils.compiled_step`), with its static bounds."""
    return (compiled_step(loss_grad_step(case, static=True),
                          key=step_key(case, True)),
            compiled_step(costs_step(case, static=True),
                          key=step_key(case, False)))


def chain_ms(case, compiled, grad=True, iters=10):
    """Chained ms of the loss+grad (``grad``) or the costs, compiled with
    the static bounds or eager, with one timer for both
    (`timing.bench_scalar_chain`, the loss or the costs folded into the
    carried scalar; compiled, the fold and the step are one graph)."""
    fn = (loss_grad_step if grad else costs_step)(case, static=compiled)
    return timing.bench_scalar_chain(
        fn, (case["xs"],), iters, reduce_out=lambda out: out[0].sum(),
        key=step_key(case, grad) if compiled else None)


def no_grad_ms(case, iters=10):
    """The compact costs without autograd, chained ms, eager."""
    return chain_ms(case, False, grad=False, iters=iters)


def compiled_readings(case, iters=10):
    """`chain_ms` of the loss+grad and the costs, compiled and eager in
    turns (eager, compiled, compiled, eager), then each compiled step's
    capture ms and pool MiB and a loss+grad replay under the profiler."""
    out = {}
    for grad, name in ((True, "loss_grad_ms"), (False, "no_grad_ms")):
        out[name] = {"eager": [], "compiled": []}
        for compiled in (False, True, True, False):
            out[name]["compiled" if compiled else "eager"].append(
                chain_ms(case, compiled, grad, iters))
    steps = compiled_steps(case)
    try:
        for step, name in zip(steps, ("loss_grad", "no_grad")):
            step(case["xs"])
            out[f"{name}_capture_ms"] = step.entry.capture_ms
            out[f"{name}_pool_mib"] = step.entry.pool_bytes / 2**20
        static = steps[0].entry.args
        prof = profile_step(lambda: steps[0](*static))
        out.update({k: prof[k] for k in ("kernels_per_call", "busy_ms",
                                         "idle_share")})
    finally:
        for step in steps:
            step.release()
    return out


def measure(case_name, iters=10, compiled=True):
    """One case's readings (module docstring), as a dict."""
    if not torch.cuda.is_available():
        raise SystemExit("packed_step needs a CUDA device")
    case = full_case(**CASES[case_name], seed=SEED, device="cuda")
    xs = case["xs"]
    hbm = timing.card_rates()[0]
    fwd, bwd = movement(case)
    out = {"packed_gather": {**movement_times(fwd, xs),
                             "bound_ms": gather_bytes(case) / hbm * 1e3,
                             **floors(case, hbm)},
           "packed_scatter": movement_times(bwd, xs)}
    step = loss_grad_step(case)
    out["loss_grad_ms"] = timing.bench_grad_chain(step, xs, iters)
    out["no_grad_ms"] = no_grad_ms(case, iters)
    prof = profile_step(lambda: step(xs))
    out.update({k: prof[k] for k in ("kernels_per_call", "busy_ms",
                                     "idle_share", "step_ms")})
    out["rows"] = [(ms, n, key[:60]) for ms, n, key in prof["rows"][:10]]
    if compiled:
        out["compiled"] = compiled_readings(case, iters)
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--case", choices=sorted(CASES), action="append")
    parser.add_argument("--tag", default="")
    parser.add_argument("--eager", action="store_true")
    args = parser.parse_args(argv)
    for name in args.case or sorted(CASES):
        print(json.dumps({"tag": args.tag, "case": name,
                          **measure(name, compiled=not args.eager)}),
              flush=True)


if __name__ == "__main__":
    main()
