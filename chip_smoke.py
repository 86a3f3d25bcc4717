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
  6. the fused joint kernels (forward; backward d_a/d_c and d_W/d_b) against
     their plain torch versions on the card (the cases and tolerances of
     `benchmarks/fused_joint_cases.py`; d_W and d_b held per column group:
     blank, label, other): ragged lengths with xn shorter than one row
     tile, U > 32 with blank=3, U > 64, H=512, V not a multiple of the
     64-column chunk, and the slice's full width.
  7. the fused slice at full width (N=16, T=150, U=21, V=5000, H=F=256,
     bf16 joint, weights carried from a seeded Flax-layout tree):
     `rnnt_loss_fused_joint(..., reduction="mean")` + backward into f, g and
     the four joint parameters, and the no-grad costs.  Launch counts are
     set to 0 just before and read just after; the three fused-joint kernels
     and both lattice kernels must have run.  Held against the port's
     unfused `Joint(normalize=True)` -> `rnnt_loss(gather=True)` on the card
     (w_out and b_out per column group).
  8. times of each fused kernel, its plain version and its bound (bf16
     tensor-core operations), and fused against unfused loss+grad, each
     with its peak device memory.

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

# The fused joint slice: bench_joint.py's configuration, U = 20 labels + 1.
FJ = dict(N=16, T=150, U=21, V=5000, H=256, F=256)

# (HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 tensor-core
# FLOP/s), NVIDIA data sheets.
_RATES = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
          "H200": (4.8e12, 67e12, 989e12)}
_RATES_SXM = (3.35e12, 67e12, 989e12)
BF16 = 2  # index of the bf16 tensor-core rate in a _RATES entry


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


def bound_ms(nbytes, nops, rates, op_rate=1):
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nops / rates[op_rate] * 1e3
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
    # end to end: the gather reads the blank and label log-prob of each row
    # (not the whole log-probs), the write stores the gradient once
    e2e_bound, _ = bound_ms(R * V * 4 + 2 * R * 4, 0, rates)
    print(f"time loss+grad (kernels): ms={e2e['cuda']} bound_ms={e2e_bound}"
          f" bound_by=bytes [{card}]")
    print(f"time loss+grad (impl=scan): ms={e2e['scan']} [{card}]")
    print(f"time loss no-grad (kernels): ms={e2e['cuda_no_grad']} [{card}]")
    return times


def fj_tree(np, seed):
    """A Flax-layout joint tree {"params": {"pre", "out"}} of numpy arrays at
    the slice's widths, lecun-normal kernels and small biases, from a seed."""
    rng = np.random.RandomState(seed)
    F, H, V = FJ["F"], FJ["H"], FJ["V"]

    def dense(fan_in, fan_out):
        return {"kernel": (rng.randn(fan_in, fan_out) / np.sqrt(fan_in)
                           ).astype(np.float32),
                "bias": (0.1 * rng.randn(fan_out)).astype(np.float32)}

    return {"params": {"pre": dense(F, H), "out": dense(H, V)}}


def fj_inputs(torch, seed):
    """Encoder/predictor outputs f (N, T, F), g (N, U, F), labels (N, U-1)
    in [1, V), full lengths, on the card."""
    N, T, U, V, F = (FJ[k] for k in "NTUVF")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn(N, T, F, generator=gen, device="cuda")
    g = torch.randn(N, U, F, generator=gen, device="cuda")
    labels = torch.randint(1, V, (N, U - 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    yn = torch.full((N,), U - 1, dtype=torch.int32, device="cuda")
    return f, g, labels, xn, yn


def phase_fused_kernels(torch, fj, cases_mod, full_case):
    """Each fused-joint kernel against its plain version, both on the card
    (so both round h from the same tanhf), by `fused_joint_cases.compare`:
    forward at atol 1e-4 on valid frames and finite everywhere; backward
    within 1e-3 of the largest plain entry, d_W and d_b per column group
    (blank, label, other columns, each against its own largest entry)."""
    cases = {name: cases_mod.kernel_case(*case)
             for name, case in cases_mod.KERNEL_CASES.items()}
    cases["full_width"] = full_case
    errs = {}
    for name, (ops, cot) in cases.items():
        a, c, w = ops[:3]
        blank = int(ops[4][0, -1])
        readings = cases_mod.compare(fj, ops, cot, blank)
        torch.cuda.synchronize()
        shape = (*a.shape[:2], c.shape[1], *w.shape[::-1])
        print(f"fused joint kernels {name} N,T,U,V,H={shape} blank={blank}:"
              f" {json.dumps(readings)}")
        if name == "full_width":
            errs = {k: cases_mod.max_err(r) for k, r in readings.items()}
    return errs


def fj_full_case(torch, fj, fjin, params):
    """The full-width kernel operands: a, c from the slice's own
    pre-projection, random lattice cotangents."""
    f, g, labels, xn, yn = fjin
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext

    with torch.no_grad():
        a, c = fj._project(f, g, params)
    lab = _labels_ext(labels, 0)
    gen = torch.Generator(device="cuda").manual_seed(24)
    N, T, U = FJ["N"], FJ["T"], FJ["U"]
    db = torch.randn(N, T, U, generator=gen, device="cuda") / N
    de = torch.randn(N, T, U, generator=gen, device="cuda") / N
    return (a, c, params["w_out"], params["b_out"], lab, xn, yn), (db, de)


FJ_PATH = ("fused_joint_fwd", "fused_joint_bwd_dadc", "fused_joint_bwd_dwdb",
           "lattice_fused", "lattice_beta_only")


def phase_fused_main(torch, wt, counters, fjin, params):
    """The fused slice once through the public entry point: loss+grad
    (reduction="mean") into f, g and the four parameters, the per-sample
    costs in grad mode, and the no-grad costs."""
    f, g, labels, xn, yn = fjin
    for c in counters:
        for key in c:
            c[key] = 0
    fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn, reduction="mean")
    loss.backward()
    costs_g = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn)
    with torch.no_grad():
        costs_ng = wt.rnnt_loss_fused_joint(f, g, params, labels, xn, yn)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if k in FJ_PATH}
    print(f"fused path launches: {launches}")
    missing = [k for k in FJ_PATH if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"fused path never launched: {missing}")
    grads = {"f": fr.grad, "g": gr.grad, **{k: v.grad for k, v in pr.items()}}
    return launches, loss.detach(), grads, costs_g.detach(), costs_ng


def check_fused_main(torch, wt, cases_mod, joint, fjin, loss, grads, costs_g,
                     costs_ng):
    """Against the port's unfused Joint(normalize=True) -> rnnt_loss(gather)
    on the card, with the same carried weights.  The module rounds its
    pre-activations and logits to bf16 (as Flax's Dense(dtype=bf16) does)
    and the fused path keeps fp32 sums, hence loss rtol 2e-3 and each
    gradient within 2e-2 of its largest entry (tests/test_fused_joint.py:
    161-165); w_out and b_out per column group (blank, label, other), each
    against its own largest entry, as in `fused_joint_cases.check_close`.
    No-grad costs equal grad-mode costs at rtol 1e-5."""
    f, g, labels, xn, yn = fjin
    groups = cases_mod.column_groups(labels, 0, FJ["V"])
    fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
    joint.zero_grad(set_to_none=True)
    lp = joint(fr, gr)
    ref = wt.rnnt_loss(lp, labels, xn, yn, reduction="mean", gather=True)
    ref.backward()
    ref = ref.detach()
    ref_grads = {"f": fr.grad, "g": gr.grad,
                 "w_pre": joint.pre.weight.grad.t(), "b_pre": joint.pre.bias.grad,
                 "w_out": joint.out.weight.grad.t(), "b_out": joint.out.bias.grad}
    del lp
    for name, x in (("loss", loss), ("costs", costs_g), ("costs_ng", costs_ng),
                    *grads.items()):
        if not torch.isfinite(x).all():
            raise AssertionError(f"fused {name} has non-finite values")
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    print(f"fused vs unfused: loss {float(loss)} vs {float(ref)} (rel err {rel})")
    if rel > 2e-3:
        raise AssertionError("fused loss differs from the unfused composition")
    for name, got in grads.items():
        readings = cases_mod.check_close(
            f"fused vs unfused grad {name}", got, ref_grads[name].float(), 2e-2,
            groups if name in ("w_out", "b_out") else None)
        print(f"fused vs unfused grad {name}: (max abs err, max |ref|)"
              f" {json.dumps(readings)}")
    if not torch.allclose(costs_ng, costs_g, rtol=1e-5, atol=0.0):
        raise AssertionError("fused no-grad costs differ from grad-mode costs")
    print(f"fused no-grad vs grad-mode costs: max abs err"
          f" {float((costs_ng - costs_g).abs().max())}")


def phase_fused_times(torch, wt, fj, timing, joint, fjin, params, full_case,
                      rates, card):
    """Each fused kernel and its plain version (CUDA events, chained), its
    bound by bf16 tensor-core operations; then fused and unfused loss+grad
    end to end, each with its peak device memory."""
    N, T, U, V, H = (FJ[k] for k in "NTUVH")
    R = N * T * U
    (a, c, w, b, lab, xn, yn), (db, de) = full_case
    blank = 0
    bl, el, logz = fj.joint_lattice_fwd(a, c, w, b, lab, xn, yn, blank)
    ops_k, lat, dims = fj._bwd_operands(a, c, w, b, lab, xn, logz, db, de, blank)
    _, _, h16 = fj._bwd_dadc(ops_k, lab, xn, lat, dims, blank)
    args = (a, c, w, b, lab, xn, yn, logz, db, de, blank)
    first = lambda out: out[0].view(-1)[0]  # noqa: E731
    prod = 2 * R * H * V  # one R x H x V product
    # bytes: a, c fp32, W bf16, b fp32, labels in; three lattices out (fwd),
    # or three lattices in and the gradients out (bwd)
    io_in = (N * T * H + N * U * H) * 4 + H * V * 2 + V * 4 + N * U * 4
    times = {}
    for name, fn, plain, fargs, nbytes, nops in (
        ("fused_joint_fwd", fj.joint_lattice_fwd, fj.joint_lattice_fwd_plain,
         (a, c, w, b, lab, xn, yn, blank), io_in + 3 * R * 4, prod),
        ("fused_joint_bwd_dadc",
         lambda *x: fj._bwd_dadc(ops_k, lab, xn, lat, dims, blank),
         fj.bwd_dadc_plain, args, io_in + 3 * R * 4 + (N * T + N * U) * H * 4,
         2 * prod),
        ("fused_joint_bwd_dwdb",
         lambda *x: fj._bwd_dwdb(h16, ops_k, lab, xn, lat, dims, blank),
         fj.bwd_dwdb_plain, args,
         R * H * 2 + H * V * 2 + V * 4 + 3 * R * 4 + (H * V + V) * 4, 2 * prod),
    ):
        ms = timing.bench_scalar_chain(fn, fargs, 10, reduce_out=first)
        plain_ms = timing.bench_scalar_chain(plain, fargs, 2, repeats=1,
                                             reduce_out=first)
        b_ms, b_by = bound_ms(nbytes, nops, rates, BF16)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"time {name}: ms={ms} plain_ms={plain_ms} bound_ms={b_ms}"
              f" bound_by={b_by} [{card}]")
    del h16

    f, g, labels, xn, yn = fjin
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}

    def fused_step(x):
        x = x.detach().requires_grad_()
        for p in pr.values():
            p.grad = None
        loss = wt.rnnt_loss_fused_joint(x, g, pr, labels, xn, yn,
                                        reduction="mean")
        loss.backward()
        return loss.detach(), x.grad

    def unfused_step(x):
        x = x.detach().requires_grad_()
        joint.zero_grad(set_to_none=True)
        loss = wt.rnnt_loss(joint(x, g), labels, xn, yn, reduction="mean",
                            gather=True)
        loss.backward()
        return loss.detach(), x.grad

    e2e = {}
    for name, step in (("fused", fused_step), ("unfused", unfused_step)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(f)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = timing.bench_grad_chain(step, f, 10)
        e2e[name] = (ms, peak)
        print(f"time loss+grad {name} joint: ms={ms} peak_mem_bytes={peak}"
              f" ({peak / 2**30:.3f} GiB above the inputs) [{card}]")
    with torch.no_grad():
        ng = timing.bench_scalar_chain(
            lambda x: wt.rnnt_loss_fused_joint(x, g, params, labels, xn, yn),
            (f,), 10)
    # the least the fused loss+grad needs: forward product + the backward's
    # three (logits, dh, dW)
    e2e_bound, _ = bound_ms(0, 4 * prod, rates, BF16)
    print(f"time loss+grad fused joint bound_ms={e2e_bound} bound_by=operations"
          f" [{card}]")
    print(f"time loss no-grad fused joint: ms={ng} [{card}]")
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
    from warp_rnnt_tpu_torch.benchmarks import fused_joint_cases as fj_cases
    from warp_rnnt_tpu_torch.benchmarks import timing
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext
    import numpy as np

    from warp_rnnt_tpu_torch.models import carry_flax_joint
    from warp_rnnt_tpu_torch.ops import _build, cuda_impl
    from warp_rnnt_tpu_torch.ops import flat_kernels as fk
    from warp_rnnt_tpu_torch.ops import fused_joint as fj

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
    del inputs, log_probs, main_lattice, ct

    # the fused joint slice: rnnt_loss_fused_joint at N=16 T=150 U=21 V=5000
    # H=F=256, weights carried from a Flax-layout tree made from the seed
    joint, params = carry_flax_joint(fj_tree(np, SEED), device="cuda")
    fjin = fj_inputs(torch, SEED + 1)
    full_case = fj_full_case(torch, fj, fjin, params)
    errs.update(phase_fused_kernels(torch, fj, fj_cases, full_case))
    fj_launches, *fj_out = phase_fused_main(
        torch, wt, [cuda_impl.LAUNCHES, fk.LAUNCHES, fj.LAUNCHES], fjin, params
    )
    check_fused_main(torch, wt, fj_cases, joint, fjin, *fj_out)
    del fj_out
    times.update(phase_fused_times(torch, wt, fj, timing, joint, fjin, params,
                                   full_case, rates, card))

    fj_src = "warp_rnnt_tpu/ops/fused_joint.py"
    sources = {"lattice_fused": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:134"),
               "lattice_beta_only": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:124"),
               "flat_write": ("flat_write.cu", "warp_rnnt_tpu/ops/flat_kernels.py:69"),
               "fused_joint_fwd": ("fused_joint.cu", f"{fj_src}:60"),
               "fused_joint_bwd_dadc": ("fused_joint.cu", f"{fj_src}:100"),
               "fused_joint_bwd_dwdb": ("fused_joint.cu", f"{fj_src}:100")}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"warp_rnnt_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": (fj_launches if name.startswith("fused") else launches)[name],
         "max_abs_err": errs[name], **times[name], "library_ms": None}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
