"""The post-sweep epilogue (`ops.cuda_impl.epilogue`) against its plain
version, and the strided reads of the lattice and of the dense write: the
cases and the comparisons, shared by `chip_smoke.py` and the `cuda` test of
`tests/test_torch_epilogue.py` (on CPU tensors both sides are plain, and the
tests run the same code there).

The kernel computes each value with the plain version's operations in its
order, so the two must agree bit for bit (`flat_write_cases.same`: equal
bits, NaN where the other has NaN): costs, the canary's mask and both
gradients, in every output dtype, with planes (element stride 1) and with
the channels of interleaved (N, T, U, 2) tensors (stride 2).  The alphas and
betas are the sweep's own on the case's log-probs (`cuda_impl.alpha_beta`
on the case's device), then edited where a case says so.

Cases:
  * "main": the main path's lattice, N=32, T=150, U=21, full lengths.
  * "edges": N=7, T=37, U=9, FastEmit 0.3; xn = 0 (the frame index wraps),
    yn >= U (clamped), a sample whose beta[0, 0] is perturbed (the canary
    trips: gradients zeroed, cost averaged), a -inf blank and label inside
    a sample's valid region, NaN log-probs in another sample.
  * "B": compact case B's lattice, N=16, T=1473, U=299, seeded lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from warp_rnnt_tpu_torch.benchmarks.flat_write_cases import _max_err, same

CASES = {
    "main": dict(N=32, T=150, U=21, lam=0.0, dtypes=("fp32", "bf16")),
    "edges": dict(N=7, T=37, U=9, lam=0.3,
                  dtypes=("fp32", "bf16", "fp16", "fp64")),
    "B": dict(N=16, T=1473, U=299, lam=0.0, dtypes=("fp32", "bf16")),
}
DTYPES = {"fp32": torch.float32, "fp64": torch.float64, "fp16": torch.float16,
          "bf16": torch.bfloat16}
STRIDES = (1, 2)


def make_lattice(N, T, U, seed, device="cuda"):
    """Seeded log-softmax blank and label log-probs (N, T, U) fp32 and
    lengths (xn in [T/2, T], yn in [0, U-1], sample 0 full), int32."""
    rng = np.random.RandomState(seed)
    z = rng.randn(N, T, U, 3)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    xn = rng.randint(T // 2, T + 1, size=N)
    yn = rng.randint(0, U, size=N)
    xn[0], yn[0] = T, U - 1
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(lp[..., 0], **f32), torch.tensor(lp[..., 1], **f32),
            torch.tensor(xn, **i32), torch.tensor(yn, **i32))


def make_case(name, cuda_impl, device="cuda", seed=0):
    """(blank, emit, alphas, betas, xn, yn, fastemit_lambda) of a case."""
    c = CASES[name]
    N, T, U = c["N"], c["T"], c["U"]
    blank, emit, xn, yn = make_lattice(N, T, U, seed, device)
    if name == "main":
        xn.fill_(T)
        yn.fill_(U - 1)
    if name == "edges":
        xn[1], yn[1] = 0, 3        # t_last = -1 wraps to T - 1
        xn[2], yn[2] = T, U + 2    # u_last clamps to U - 1
        blank[4, 3, 2] = -np.inf   # inside sample 4's valid region
        emit[4, 5, 1] = -np.inf
        blank[5, 7, 0] = np.nan    # sample 5's sweep is NaN
        emit[6, T - 1, U - 1] = np.nan
    alphas, betas = cuda_impl.alpha_beta(blank, emit, xn, yn)
    if name == "edges":
        betas[3, 0, 0] *= 1.01     # sample 3 trips the canary
    return blank, emit, alphas, betas, xn, yn, c["lam"]


def interleaved(a, b):
    """The two (N, T, U) tensors as the channels of one contiguous
    (N, T, U, 2) tensor: (channel 0, channel 1, the tensor)."""
    both = torch.stack([a, b], dim=-1)
    return both[..., 0], both[..., 1], both


def outputs(shape, dtype, stride, device):
    """(g_blank, g_emit, whole): planes at stride 1, channels of one
    (N, T, U, 2) tensor at stride 2 (whole is then that tensor)."""
    if stride == 1:
        g0 = torch.empty(shape, dtype=dtype, device=device)
        g1 = torch.empty(shape, dtype=dtype, device=device)
        return g0, g1, None
    whole = torch.empty((*shape, 2), dtype=dtype, device=device)
    return whole[..., 0], whole[..., 1], whole


def run(fn, case, dtype, stride):
    """``fn`` (`epilogue` or `epilogue_plain`) on a case with inputs and
    outputs at ``stride``: (costs, mask, g_blank, g_emit)."""
    blank, emit, alphas, betas, xn, yn, lam = case
    if stride == 2:
        blank, emit, _ = interleaved(blank, emit)
    g0, g1, _ = outputs(tuple(alphas.shape), dtype, stride, alphas.device)
    costs, bad = fn(blank, emit, alphas, betas, xn, yn, lam, g0, g1)
    return costs, bad, g0, g1


def compare(cuda_impl, name, device="cuda", seed=0):
    """The kernel against its plain version on one case, every dtype and
    stride, bit for bit.  Returns {"dtype stride": max_abs_err (0.0)} and
    the canary's mask; raises AssertionError."""
    case = make_case(name, cuda_impl, device, seed)
    out = {}
    for d in CASES[name]["dtypes"]:
        for stride in STRIDES:
            got = run(cuda_impl.epilogue, case, DTYPES[d], stride)
            want = run(cuda_impl.epilogue_plain, case, DTYPES[d], stride)
            if device == "cuda":
                torch.cuda.synchronize()
            for what, g, w in zip(("costs", "mask", "g_blank", "g_emit"),
                                  got, want):
                if not (torch.equal(g, w) if what == "mask" else same(g, w)):
                    raise AssertionError(
                        f"epilogue {name} {d} stride {stride}: {what} of the"
                        f" kernel != plain version, max abs err"
                        f" {_max_err(g, w) if what != 'mask' else 'mask'}")
            out[f"{d} stride {stride}"] = 0.0
    out["mask"] = want[1].tolist() if name != "B" else int(want[1].sum())
    return out


def lattice_strides(cuda_impl, name="edges", device="cuda", seed=0):
    """The sweep on the channels of the interleaved lattice against the
    sweep on two planes, bit for bit (NaN alike), fused and beta only."""
    blank, emit, alphas, betas, xn, yn, _ = make_case(name, cuda_impl,
                                                      device, seed)
    b2, e2, _ = interleaved(blank, emit)
    for compute_alpha in (True, False):
        planes = cuda_impl.alpha_beta(blank, emit, xn, yn, compute_alpha)
        strided = cuda_impl.alpha_beta(b2, e2, xn, yn, compute_alpha)
        for p, s in zip(planes, strided):
            if p is not None and not same(s, p):
                raise AssertionError(
                    f"lattice {name} compute_alpha={compute_alpha}: stride 2"
                    f" != stride 1, max abs err {_max_err(s, p)}")
    return 0.0


def write_strides(fk, name="V=50 fp32", device="cuda", seed=0):
    """The dense write from the channels of an interleaved (N, T, U, 2)
    cotangent against the write from two planes, bit for bit (NaN rows
    alike), on a case of `flat_write_cases` (its non-finite cotangents
    included), through ``fk`` (`ops.flat_kernels`): the kernel on the card,
    and the plain version on both sides."""
    from warp_rnnt_tpu_torch.benchmarks import flat_write_cases as fwc

    c = fwc.CASES[name]
    args = fwc.make_inputs(**c, seed=seed, device=device)
    c0, c1, _ = interleaved(args[0], args[1])
    out = {}
    for label, fn in (("kernel", fk.flat_grad_write),
                      ("plain", fk.flat_grad_write_plain)):
        planes = fn(*args[:6], out_dtype=args[6], offset=args[7])
        strided = fn(c0, c1, *args[2:6], out_dtype=args[6], offset=args[7])
        if not same(strided, planes):
            raise AssertionError(f"flat_write {name} {label}: stride 2 !="
                                 f" stride 1, max abs err"
                                 f" {_max_err(strided, planes)}")
        out[label] = 0.0
    return out
