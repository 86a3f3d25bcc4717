"""The benchmark tier's checks on a CUDA device, in one place:
`chip_smoke.py` runs them at the benchmarks' full widths and
`tests/test_torch_bench_card.py` at small ones.  Each check raises an
AssertionError on a failure.

  * `check_table_row`: one row of warp-rnnt's README table
    (`bench_loss.make_batch`), loss+grad and the no-grad costs on the
    kernels against ``impl="scan"`` on the same inputs: costs rtol 1e-5,
    gradient within 5e-3 of its largest entry (the main path's
    tolerances, `chip_smoke.py` phase 4); and the row's data movement
    against the plain versions exactly (`check_row_movement`), since the
    scan's own gather and write run the same kernels on the card;
  * `check_long_lattice`: the lattice kernel at the table's padded
    T=1500, 300-label shape at N=128 (two waves of blocks on 132 SMs)
    against the plain twin in float64 on a subset of the samples, valid
    cells within 1e-5 |p| + 1e-5 (`chip_smoke.py` phase 2's rule);
  * `check_joint_modes`: `bench_joint`'s five modes on the same inputs and
    weights, each mode's loss within rtol 2e-3 of "log_softmax+gather"'s
    and each joint-parameter gradient within 2e-2 of the largest entry of
    "log_softmax+gather"'s (the joint layouts' tolerances, `chip_smoke.py`
    phase 11), each launching exactly its route's kernels;
  * `trace_main_path`: `utils.profiling.trace` of main-path loss+grad
    calls and its `op_breakdown`.
Every call is eager (``compiled=False``: a compiled step counts its
launches at its capture, none at a replay) and is run with the launch
counts set to 0 just before and read just after (`serving_cases.launched`).
"""

from __future__ import annotations

import math

import torch

from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
from warp_rnnt_tpu_torch.benchmarks.serving_cases import launched
from warp_rnnt_tpu_torch.functional.core import rnnt_core
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.ops import cuda_impl, flat_kernels, gather_kernels

# The kernels each bench_joint route launches in a loss+grad call (at
# H <= 256: one slice, no h image kernel).
ROUTE_KERNELS = {
    "log_softmax+gather": ("gather_lattice", "lattice_fused",
                           "lattice_epilogue", "flat_write"),
    "from_logits": ("lattice_fused", "lattice_epilogue"),
    "padded": ("lattice_fused", "lattice_epilogue"),
    "compact": ("packed_gather", "packed_scatter", "lattice_fused",
                "lattice_epilogue"),
    "fused": ("fused_joint_fwd", "fused_joint_bwd_dadc", "fused_joint_bwd_dwdb",
              "lattice_fused", "lattice_epilogue"),
}
TABLE_KERNELS = {"loss_grad": ("gather_lattice", "lattice_fused",
                               "lattice_epilogue", "flat_write"),
                 "no_grad": ("gather_lattice", "lattice_beta_only")}
# The kernels' symbols in the profiler's names, by `LAUNCHES` name.
MAIN_SYMBOLS = {"gather_lattice": "column_gather_kernel",
                "lattice_fused": "lattice_kernel",
                "lattice_epilogue": "epilogue_kernel",
                "flat_write": "flat_write_kernel"}
COST_RTOL, GRAD_TOL = 1e-5, 5e-3
MODE_LOSS_RTOL, MODE_GRAD_TOL = 2e-3, 2e-2


def _expect(what, launches, kernels):
    if set(launches) != set(kernels):
        raise AssertionError(f"{what} launched {launches}; its kernels are"
                             f" {kernels}")


def check_row_movement(xs, ys, xn, yn, blank=0):
    """`gather_lattice` on a row's log-probs and `flat_grad_write` on the
    lattice cotangent its mean loss gives, each against its plain version
    on the same inputs, bit for bit.  Returns {"gather_lattice",
    "flat_write"}: the largest absolute difference (0.0)."""
    N, T, U1, V = xs.shape
    loc = _labels_ext(ys, blank)
    lat = gather_kernels.gather_lattice(xs, loc, blank)
    lat_plain = gather_kernels.gather_lattice_plain(xs, loc, blank)
    g = lat_plain.detach().requires_grad_()
    rnnt_core(g, xn, yn).mean().backward()
    args = (g.grad[..., 0].contiguous(), g.grad[..., 1].contiguous(), loc,
            blank, V, U1 * V)
    d = flat_kernels.flat_grad_write(*args)
    d_plain = flat_kernels.flat_grad_write_plain(*args)
    errs = {}
    for name, got, want in (("gather_lattice", lat, lat_plain),
                            ("flat_write", d, d_plain)):
        errs[name] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} at {(N, T, U1, V)} against its"
                                 f" plain version: max abs err {errs[name]}")
    return errs


def check_table_row(T, U, V, N=1, seed=0):
    """One table row on the kernels against the scan, and its data
    movement against the plain versions (`check_row_movement`).  Returns
    ({"costs", "loss", "grad_share"}: the largest relative cost error, the
    loss's and the gradient's largest error over its largest entry;
    "gather_lattice", "flat_write": their max abs err; {"loss_grad",
    "no_grad"}: the launches of each call)."""
    xs, ys, xn, yn = bl.make_batch(seed, N, T, U, V)
    (loss, grad), l_grad = launched(
        lambda: bl.loss_grad_step(ys, xn, yn, compiled=False)(xs))
    costs, l_costs = launched(
        lambda: bl.costs_fn(ys, xn, yn, compiled=False)(xs))
    _expect(f"table row {(T, U, V, N)} loss+grad", l_grad,
            TABLE_KERNELS["loss_grad"])
    _expect(f"table row {(T, U, V, N)} no-grad", l_costs,
            TABLE_KERNELS["no_grad"])
    loss_s, grad_s = bl.loss_grad_step(ys, xn, yn, impl="scan",
                                       compiled=False)(xs)
    costs_s = bl.costs_fn(ys, xn, yn, impl="scan", compiled=False)(xs)
    for name, x in (("loss", loss), ("grad", grad), ("costs", costs)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"table row {(T, U, V, N)}: {name} not finite")
    errs = {"costs": float(((costs - costs_s).abs() / costs_s.abs()).max()),
            "loss": abs(float(loss) - float(loss_s)) / abs(float(loss_s)),
            "grad_share": float((grad - grad_s).abs().max()
                                / grad_s.abs().max())}
    if (max(errs["costs"], errs["loss"]) > COST_RTOL
            or errs["grad_share"] > GRAD_TOL):
        raise AssertionError(f"table row {(T, U, V, N)} against the scan:"
                             f" {errs}")
    errs.update(check_row_movement(xs, ys, xn, yn))
    return errs, {"loss_grad": l_grad, "no_grad": l_costs}


def check_long_lattice(N=128, T=1500, U=300, V=50, samples=(0, 1, 64, 127),
                       seed=0):
    """The lattice kernel on an (N, T, U+1) lattice drawn as the table's
    surrogate log-probs are (randn * 0.5 - log V), lengths as
    `bench_loss.make_batch` draws them, against `alpha_beta_plain` in
    float64 on ``samples``.  Returns ({"lattice_fused",
    "lattice_beta_only"}: max abs err on valid cells, the launches)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.randn(2, N, T, U + 1, generator=gen, device="cuda")
    lat.mul_(0.5).sub_(math.log(V))
    blank, emit = lat[0], lat[1]
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    yn = torch.randint(U // 2 + 1, U + 1, (N,), generator=gen,
                       dtype=torch.int32, device="cuda")
    idx = torch.tensor(samples, device="cuda")
    ti = torch.arange(T, device="cuda")[None, :, None]
    ui = torch.arange(U + 1, device="cuda")[None, None, :]
    mask = (ti < xn[idx, None, None]) & (ui <= yn[idx, None, None])
    errs, launches = {}, {}
    for alpha in (True, False):
        name = "lattice_fused" if alpha else "lattice_beta_only"
        (ka, kb), launches[name] = launched(
            lambda: cuda_impl.alpha_beta(blank, emit, xn, yn, alpha))
        pa, pb = cuda_impl.alpha_beta_plain(blank[idx], emit[idx], xn[idx],
                                            yn[idx], alpha, dtype=torch.float64)
        err = 0.0
        for k, p in [(kb, pb)] + ([(ka, pa)] if alpha else []):
            k, p = k[idx][mask].double(), p[mask]
            diff = (k - p).abs()
            if not torch.isfinite(k).all() or not (
                    diff <= 1e-5 * p.abs() + 1e-5).all():
                raise AssertionError(f"long lattice {(N, T, U + 1)} {name}:"
                                     f" max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
        errs[name] = err
    return errs, launches


def check_joint_modes(N, T, U, V, H, rand_length, seed=0):
    """`bench_joint`'s modes on one set of inputs and weights, on the card.
    Returns ({mode: {"loss_rel", "grad_share"}} against
    "log_softmax+gather", {mode: launches}, {mode: route})."""
    from warp_rnnt_tpu_torch.models.joint import carry_flax_joint

    f, g, ys, xn, yn = bj.make_inputs(seed, N, T, U, H, rand_length)
    joint, _ = carry_flax_joint(bj.joint_tree(seed + 1, H, V), device="cuda")
    packed = bj.pack(ys, xn, yn, T, U)
    out, launches, routes = {}, {}, {}
    for mode in bj.MODES:
        out[mode], launches[mode] = launched(
            lambda: bj.value_and_grad(mode, joint, f, g, ys, xn, yn, packed))
        routes[mode] = bj.route(mode, f, V, H)
        _expect(f"bench_joint {mode}", launches[mode],
                ROUTE_KERNELS[routes[mode]])
    ref_loss, ref_grads = out["log_softmax+gather"]
    errs = {}
    for mode, (loss, grads) in out.items():
        share = 0.0
        for layer in ("pre", "out"):
            for name in ("kernel", "bias"):
                got, want = grads[layer][name], ref_grads[layer][name]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{mode} {layer}/{name} not finite")
                share = max(share, float((got - want).abs().max()
                                         / want.abs().max()))
        errs[mode] = {"loss_rel": abs(float(loss) - float(ref_loss))
                      / abs(float(ref_loss)), "grad_share": share}
        if errs[mode]["loss_rel"] > MODE_LOSS_RTOL or share > MODE_GRAD_TOL:
            raise AssertionError(f"bench_joint {mode} against"
                                 f" log_softmax+gather: {errs[mode]}")
    return errs, launches, routes


def trace_main_path(path, N=32, T=150, U=20, V=5000, calls=3, seed=0):
    """`calls` main-path loss+grad calls under `utils.profiling.trace`,
    writing the trace under ``path``; returns `op_breakdown`'s rows."""
    from warp_rnnt_tpu_torch.utils.profiling import op_breakdown, trace

    xs, ys, xn, yn = bl.make_batch(seed, N, T, U, V)
    step = bl.loss_grad_step(ys, xn, yn, compiled=False)
    step(xs)
    torch.cuda.synchronize()
    with trace(path):
        for _ in range(calls):
            step(xs)
    return op_breakdown(path)


def missing_symbols(rows):
    """The `MAIN_SYMBOLS` kernels whose symbol names no row."""
    return [k for k, sym in MAIN_SYMBOLS.items()
            if not any(sym in name for _, name in rows)]
