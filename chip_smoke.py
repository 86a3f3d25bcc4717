#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`warp_rnnt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card and build: the card's name and power limit, then nvcc builds the
     kernels in `warp_rnnt_tpu_torch/csrc/` (one nvcc per source, together).
  2. the lattice kernels (fused alpha+beta, beta only) against their plain
     torch twin on the card: small ragged shapes, a T longer than one block,
     and the main path's full-width lattice.
  3. the gradient-write kernel against its twin: full width, and a V that is
     not a multiple of 4 in every output dtype.  The match must be exact.
  4. the main path at full width (N=32, T=150, U=21, V=5000, fp32):
     `rnnt_loss(..., reduction="mean", gather=True)` + backward on the 4-D and
     the flat 3-D input, and the no-grad costs.  Launch counts are set to 0
     just before and read just after; every kernel must have run.  Costs and
     the 2 GB gradient are held against `impl="scan"` on the card, and the
     golden vectors of `tests/golden.py` run through the port on the card.
  5. times (CUDA events, dependency-forced chains) of each kernel, its twin,
     and loss+grad end to end, each beside its bound.

It prints the kernels' JSON line and the card's line, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N, T, U, V = 32, 150, 21, 5000  # warp-rnnt's headline config, U = 20 labels + 1
SEED = 0

# (HBM bytes/s, fp32 FLOP/s outside the tensor cores), NVIDIA data sheets.
_RATES = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
          "H200": (4.8e12, 67e12)}
_RATES_SXM = (3.35e12, 67e12)


def card_rates(name):
    for key, rates in _RATES.items():
        if key in name:
            return rates
    return _RATES_SXM


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bound_ms(nbytes, nops, rates):
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(torch, n, t, u, v, seed, device="cuda"):
    """Seeded log_softmax log-probs (n, t, u, v), labels (n, u-1) in [1, v),
    full lengths; all int32 where the loss wants int32."""
    g = torch.Generator(device=device).manual_seed(seed)
    log_probs = torch.log_softmax(
        torch.randn(n, t, u, v, generator=g, device=device), dim=-1
    )
    labels = torch.randint(1, v, (n, u - 1), generator=g, device=device,
                           dtype=torch.int32)
    xn = torch.full((n,), t, dtype=torch.int32, device=device)
    yn = torch.full((n,), u - 1, dtype=torch.int32, device=device)
    return log_probs, labels, xn, yn


def random_lattice(torch, n, t, u, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(n, t, u, 3, generator=g, device=device), -1)
    return lp[..., 0].contiguous(), lp[..., 1].contiguous()


def valid_mask(torch, xn, yn, t, u):
    ti = torch.arange(t, device=xn.device)[None, :, None]
    ui = torch.arange(u, device=xn.device)[None, None, :]
    return (ti < xn[:, None, None]) & (ui <= yn[:, None, None])


def phase_lattice(torch, cuda_impl, main_lattice):
    """Kernel vs twin on valid cells: |k - p| <= 1e-5 |p| + 1e-5.  The kernel
    and the twin run the same scan in the same order (one chunk up to
    T=256), so they differ only by the rounding of expf/log1pf."""
    i32 = dict(dtype=torch.int32, device="cuda")
    cases = [
        ("ragged", *random_lattice(torch, 6, 37, 9, 1),
         torch.tensor([37, 20, 1, 37, 5, 30], **i32),
         torch.tensor([8, 3, 0, 8, 0, 5], **i32)),
        ("long_T", *random_lattice(torch, 3, 600, 4, 2),
         torch.tensor([600, 333, 257], **i32), torch.tensor([3, 1, 2], **i32)),
        ("full_width", *main_lattice),
    ]
    errs = {}
    for name, blank, emit, xn, yn in cases:
        mask = valid_mask(torch, xn, yn, blank.shape[1], blank.shape[2])
        for compute_alpha in (True, False):
            ka, kb = cuda_impl.alpha_beta(blank, emit, xn, yn, compute_alpha)
            pa, pb = cuda_impl.alpha_beta_plain(blank, emit, xn, yn, compute_alpha)
            torch.cuda.synchronize()
            pairs = [(kb, pb)] + ([(ka, pa)] if compute_alpha else [])
            err = 0.0
            for k, p in pairs:
                k, p = k[mask], p[mask]
                if not torch.isfinite(k).all():
                    raise AssertionError(f"lattice {name}: non-finite valid cell")
                diff = (k - p).abs()
                if not (diff <= 1e-5 * p.abs() + 1e-5).all():
                    raise AssertionError(
                        f"lattice {name} compute_alpha={compute_alpha}:"
                        f" max abs err {float(diff.max())}"
                    )
                err = max(err, float(diff.max()))
            kname = "lattice_fused" if compute_alpha else "lattice_beta_only"
            print(f"lattice {kname} {name} {tuple(blank.shape)}: max abs err"
                  f" on valid cells {err}")
            if name == "full_width":
                errs[kname] = err
    return errs


def phase_write(torch, fk, loc_rows):
    """Kernel vs twin, exact (torch.equal), including rows where loc == blank."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ct0 = torch.randn(N, T, U, generator=g, device="cuda")
    ct1 = torch.randn(N, T, U, generator=g, device="cuda")
    k = fk.flat_grad_write(ct0, ct1, loc_rows, 0, V, U * V)
    p = fk.flat_grad_write_plain(ct0, ct1, loc_rows, 0, V, U * V)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError("flat_write full width: kernel != twin")
    print(f"flat_write full width {tuple(k.shape)} float32: exact")
    del k, p

    n, t, u, v = 2, 7, 5, 131
    c0 = torch.randn(n, t, u, generator=g, device="cuda")
    c1 = torch.randn(n, t, u, generator=g, device="cuda")
    loc = torch.tensor([[5, 0, 130, 7, 0], [0, 1, 2, 3, 0]], dtype=torch.int32,
                       device="cuda")
    for dtype in (torch.float32, torch.float64, torch.float16, torch.bfloat16):
        k = fk.flat_grad_write(c0, c1, loc, 0, v, u * v, dtype)
        p = fk.flat_grad_write_plain(c0, c1, loc, 0, v, u * v, dtype)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"flat_write V={v} {dtype}: kernel != twin")
        print(f"flat_write V={v} {dtype}: exact")
    return ct0, ct1


def phase_main(torch, wt, counters, inputs):
    """The main path once, through the public entry points."""
    log_probs, labels, xn, yn = inputs
    for c in counters:
        for key in c:
            c[key] = 0

    lp = log_probs.detach().requires_grad_()
    loss = wt.rnnt_loss(lp, labels, xn, yn, reduction="mean", gather=True)
    loss.backward()
    lp3 = log_probs.detach().view(N, T, U * V).requires_grad_()
    loss3 = wt.rnnt_loss(lp3, labels, xn, yn, reduction="mean", gather=True)
    loss3.backward()
    with torch.no_grad():
        costs_ng = wt.rnnt_loss(log_probs, labels, xn, yn, gather=True)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    print(f"main path launches: {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    return launches, loss, lp.grad, loss3, lp3.grad, costs_ng


def check_main(torch, wt, inputs, loss, grad, loss3, grad3, costs_ng):
    """Against impl="scan" on the card.  Costs: rtol 1e-5 (fp32 sums of ~170
    log-probs near -9).  Gradient: max |diff| <= 5e-3 * max |grad|: each
    entry is exp(alpha + lp + beta - ll) with |ll| ~ 1.5e3, where fp32
    rounding of the two sweeps leaves ~1e-3 of absolute error in the
    exponent."""
    log_probs, labels, xn, yn = inputs
    loss, loss3 = loss.detach(), loss3.detach()
    if grad.shape != (N, T, U, V) or grad3.shape != (N, T, U * V):
        raise AssertionError(f"gradient shapes {grad.shape}, {grad3.shape}")
    for name, x in (("loss", loss), ("grad", grad), ("costs_ng", costs_ng)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} has non-finite values")
    if not (torch.equal(loss, loss3) and torch.equal(grad.view(-1), grad3.view(-1))):
        raise AssertionError("flat 3-D path differs from the 4-D path")

    lp_s = log_probs.detach().requires_grad_()
    loss_s = wt.rnnt_loss(lp_s, labels, xn, yn, reduction="mean", gather=True,
                          impl="scan")
    loss_s.backward()
    loss_s = loss_s.detach()
    costs_s = wt.rnnt_loss(log_probs, labels, xn, yn, impl="scan").detach()
    loss_err = abs(float(loss) - float(loss_s))
    grad_err = float((grad - lp_s.grad).abs().max())
    grad_scale = float(lp_s.grad.abs().max())
    cost_err = float((costs_ng - costs_s).abs().max())
    print(f"main path vs scan: loss {float(loss)} vs {float(loss_s)}"
          f" (abs err {loss_err}); costs no-grad max abs err {cost_err};"
          f" grad max abs err {grad_err} (max |grad| {grad_scale})")
    if loss_err > 1e-5 * abs(float(loss_s)):
        raise AssertionError("loss differs from the scan")
    if not torch.allclose(costs_ng, costs_s, rtol=1e-5, atol=0.0):
        raise AssertionError("no-grad costs differ from the scan")
    if grad_err > 5e-3 * grad_scale:
        raise AssertionError("gradient differs from the scan")
    return grad_err


def check_golden(torch, wt):
    """The golden vectors of the reference test suite, through the port on
    the card (tolerances of tests/test_torch_binding.py)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import golden

    for name, case in sorted(golden.ALL_PADDED_CASES.items()):
        xs = torch.tensor(case["xs"], dtype=torch.float32, device="cuda",
                          requires_grad=True)
        ys, xn, yn = (torch.tensor(case[k], device="cuda") for k in ("ys", "xn", "yn"))
        costs = wt.rnnt_loss(xs, ys, xn, yn, gather=True)
        costs.sum().backward()
        exp_c = torch.tensor(case["expected_costs"], dtype=torch.float32)
        exp_g = torch.tensor(case["expected_grads"], dtype=torch.float32)
        if not (torch.allclose(costs.detach().cpu(), exp_c, rtol=1e-4, atol=2e-5)
                and torch.allclose(xs.grad.cpu(), exp_g, rtol=1e-4, atol=2e-5)):
            raise AssertionError(f"golden case {name} differs")
        print(f"golden {name}: ok")


def phase_times(torch, wt, cuda_impl, fk, timing, inputs, main_lattice,
                ct, rates, card):
    log_probs, labels, xn, yn = inputs
    blank, emit, xn_l, yn_l = main_lattice
    ct0, ct1, loc_rows = ct
    R = N * T * U
    steps = math.ceil(math.log2(T))
    first = lambda out: out[1].view(-1)[0]  # noqa: E731  one element of betas
    times = {}

    def kernel(name, fn, plain, args, reduce_out, nbytes, nops, iters):
        ms = timing.bench_scalar_chain(fn, args, iters, reduce_out=reduce_out)
        plain_ms = timing.bench_scalar_chain(plain, args, max(2, iters // 4),
                                             reduce_out=reduce_out)
        b_ms, b_by = bound_ms(nbytes, nops, rates)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"time {name}: ms={ms} plain_ms={plain_ms} bound_ms={b_ms}"
              f" bound_by={b_by} [{card}]")

    # lattice: reads blank+emit, writes alphas and/or betas; ~8 fp32
    # operations per cell per scan step per direction
    kernel("lattice_fused", cuda_impl.alpha_beta, cuda_impl.alpha_beta_plain,
           (blank, emit, xn_l, yn_l, True), first,
           4 * R * 4 + 2 * N * 4, 2 * R * steps * 8, 20)
    kernel("lattice_beta_only", cuda_impl.alpha_beta, cuda_impl.alpha_beta_plain,
           (blank, emit, xn_l, yn_l, False), first,
           3 * R * 4 + 2 * N * 4, R * steps * 8, 20)
    # write: reads ct0, ct1, loc_rows, writes R*V fp32; 4 operations per element
    kernel("flat_write", fk.flat_grad_write, fk.flat_grad_write_plain,
           (ct0, ct1, loc_rows, 0, V, U * V), lambda d: d.view(-1)[0],
           R * V * 4 + 2 * R * 4 + N * U * 4, R * V * 4, 20)

    def loss_grad(impl):
        def step(x):
            x = x.detach().requires_grad_()
            loss = wt.rnnt_loss(x, labels, xn, yn, reduction="mean", gather=True,
                                impl=impl)
            loss.backward()
            return loss.detach(), x.grad
        return step

    e2e = {}
    for impl, iters in (("cuda", 20), ("scan", 4)):
        e2e[impl] = timing.bench_grad_chain(loss_grad(impl), log_probs, iters)
    with torch.no_grad():
        e2e["cuda_no_grad"] = timing.bench_scalar_chain(
            lambda x: wt.rnnt_loss(x, labels, xn, yn, gather=True), (log_probs,), 20
        )
    # end to end: read log-probs once (gather), write the gradient once
    e2e_bound, _ = bound_ms(2 * R * V * 4, 0, rates)
    print(f"time loss+grad (kernels): ms={e2e['cuda']} bound_ms={e2e_bound}"
          f" bound_by=bytes [{card}]")
    print(f"time loss+grad (impl=scan): ms={e2e['scan']} [{card}]")
    print(f"time loss no-grad (kernels): ms={e2e['cuda_no_grad']} [{card}]")
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "warp_rnnt_tpu_torch")):
        print("chip_smoke: warp_rnnt_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import warp_rnnt_tpu_torch as wt
    from warp_rnnt_tpu_torch.benchmarks import timing
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext
    from warp_rnnt_tpu_torch.ops import _build, cuda_impl
    from warp_rnnt_tpu_torch.ops import flat_kernels as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    rates = card_rates(kind)
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_build.SOURCES)}"
          " sources in parallel)")

    inputs = make_inputs(torch, N, T, U, V, SEED)
    log_probs, labels, xn, yn = inputs
    loc_rows = _labels_ext(labels, 0)
    idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
    main_lattice = (log_probs[..., 0].contiguous(),
                    torch.gather(log_probs, 3, idx)[..., 0].contiguous(), xn, yn)

    errs = phase_lattice(torch, cuda_impl, main_lattice)
    ct = (*phase_write(torch, fk, loc_rows), loc_rows)
    errs["flat_write"] = 0.0

    launches, loss, grad, loss3, grad3, costs_ng = phase_main(
        torch, wt, [cuda_impl.LAUNCHES, fk.LAUNCHES], inputs
    )
    check_main(torch, wt, inputs, loss, grad, loss3, grad3, costs_ng)
    del loss, grad, loss3, grad3
    check_golden(torch, wt)

    times = phase_times(torch, wt, cuda_impl, fk, timing, inputs, main_lattice,
                        ct, rates, card)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    sources = {"lattice_fused": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:134"),
               "lattice_beta_only": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:124"),
               "flat_write": ("flat_write.cu", "warp_rnnt_tpu/ops/flat_kernels.py:69")}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"warp_rnnt_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         **times[name], "library_ms": None}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
