"""The transducer's train step on the card: its cases, the kernels each loss
mode launches, and the comparisons, shared by `chip_smoke.py` and the
`cuda`-marked tests of `tests/test_torch_train_card.py`.

  * `flax_tree`: a seeded Flax-layout `Transducer` parameter tree of numpy
    arrays (the paths `carry_flax_transducer` reads), any widths.
  * `PATHS`: the kernels a train step launches in each loss mode, by their
    `LAUNCHES` names; `launches_per_step` runs one step with the counts
    set to 0 just before and read just after, and checks them.
  * `compare_grads`: one mode against another, with the tolerance of
    `tests/test_fused_joint.py:201-205` (loss rtol 2e-3; each gradient
    within rtol 0.1 and atol 3e-2 of its largest entry: the joints round
    to bf16 at different places).
  * `recorded_lattice` and `lattice_matches_plain`: the lattice sweeps a
    step runs on the card, each held against the plain version in float64
    on the same inputs.
  * `compare_steps`: the parameters after one AdamW step on two sides.
  * `card_matches_cpu`: one train step on the card against the same step
    on the CPU (same parameters, same batch), in a mode: loss and
    gradients with `compare_grads`, the parameters with `compare_steps`.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from warp_rnnt_tpu_torch.models import (
    carry_flax_transducer,
    init_model,
    make_train_step,
    transducer_loss_fn,
)

LR, WEIGHT_DECAY = 1e-3, 1e-4  # optax.adamw(1e-3)
LOSS_RTOL = 2e-3
GRAD_RTOL, GRAD_REL_ATOL = 0.1, 3e-2
# Adam's first step moves a parameter by lr g / (|g| + eps), eps 1e-8: a
# gradient above 1e-5 moves it by lr to 1e-3.  Two steps whose gradients
# share a sign there agree within 1e-2 lr.
STEP_ATOL, STEP_GRAD_MIN = 1e-2 * LR, 1e-5
# The lattice against its float64 plain version, as the main path holds it:
# alphas and betas on valid cells within 1e-5 |p| + 1e-5, costs rtol 1e-5,
# gradients within 5e-3 of their largest.
LATTICE_TOL, COST_RTOL, LATTICE_GRAD_TOL = 1e-5, 1e-5, 5e-3

# Kernels a train step launches, by loss mode.  "fused" launches the h
# image kernel only past one 256-column slice of the joint's width.
PATHS = {
    "from_logits": ("lattice_fused", "lattice_epilogue"),
    "gather": ("gather_lattice", "lattice_fused", "lattice_epilogue",
               "flat_write"),
    "fused": ("lattice_fused", "lattice_epilogue", "fused_joint_fwd",
              "fused_joint_bwd_dadc",
              "fused_joint_bwd_dwdb", "fused_joint_hidden"),
}

# bench_train.py's shape: N=32, T=400, U=40 (39 labels + 1), V=1024, 80
# features, hidden 512 everywhere, two conv blocks, "add" joint.
FULL = dict(N=32, T=400, U=40, V=1024, F=80, H=512)
SMALL = dict(N=3, T=24, U=6, V=40, F=12, H=32)


def counters():
    from warp_rnnt_tpu_torch.ops import cuda_impl, flat_kernels, fused_joint
    from warp_rnnt_tpu_torch.ops import gather_kernels

    return [cuda_impl.LAUNCHES, flat_kernels.LAUNCHES, fused_joint.LAUNCHES,
            gather_kernels.LAUNCHES]


def expected(mode, H):
    return tuple(k for k in PATHS[mode]
                 if k != "fused_joint_hidden" or H > 256)


def flax_tree(seed, V, F, H):
    """A Flax-layout Transducer tree {"params": {"encoder", "predictor",
    "joint"}} of numpy arrays (two conv blocks of width 5, as the
    Transducer has): kernels normal with variance 1 / fan_in, small
    biases, layernorm scales near 1, from a seed."""
    kernel = 5
    rng = np.random.RandomState(seed)

    def normal(*shape, scale):
        return (scale * rng.randn(*shape)).astype(np.float32)

    def dense(fan_in, fan_out, bias=True):
        d = {"kernel": normal(fan_in, fan_out, scale=fan_in ** -0.5)}
        if bias:
            d["bias"] = normal(fan_out, scale=0.1)
        return d

    def norm():
        return {"scale": 1 + normal(H, scale=0.1), "bias": normal(H, scale=0.1)}

    enc = {"inp": dense(F, H), "out_ln": norm()}
    for i in range(2):
        enc[f"conv_blocks_{i}"] = {
            "ln": norm(),
            "conv": {"kernel": normal(kernel, H, 2 * H,
                                      scale=(kernel * H) ** -0.5),
                     "bias": normal(2 * H, scale=0.1)}}
    cell = {g: dense(H, H) for g in ("ir", "iz", "in", "hn")}
    cell.update({g: dense(H, H, bias=False) for g in ("hr", "hz")})
    pred = {"embed": {"embedding": normal(V, H, scale=H ** -0.5)},
            "cell": cell}
    return {"params": {"encoder": enc, "predictor": pred,
                       "joint": {"pre": dense(H, H), "out": dense(H, V)}}}


def make_batch(seed, N, T, U, V, F, device="cuda"):
    """feats normal (N, T, F), labels in [1, V) (N, U-1), full xn, yn in
    [U // 2, U) with the first sample full; int32, from a seed."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, F).astype(np.float32)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.full((N,), T, np.int32)
    yn = rng.randint(max(U // 2, 1), U, (N,)).astype(np.int32)
    yn[0] = U - 1
    return tuple(torch.tensor(x, device=device)
                 for x in (feats, labels, xn, yn))


def carried(seed, dims, device="cuda"):
    """(model, batch) at ``dims`` (`FULL`, `SMALL`): the model carried from
    `flax_tree`, the batch from `make_batch`, both from one seed."""
    d = dims
    model = carry_flax_transducer(flax_tree(seed, d["V"], d["F"], d["H"]),
                                  device=device)
    return model, make_batch(seed + 1, d["N"], d["T"], d["U"], d["V"], d["F"],
                             device)


def loss_and_grads(model, batch, mode):
    """(loss, {parameter name: gradient}) of one loss+grad in ``mode``."""
    model.zero_grad(set_to_none=True)
    loss = transducer_loss_fn(model, batch, loss_mode=mode)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()}


def launches_per_step(model, batch, mode):
    """One loss+grad in ``mode`` with every launch count set to 0 just
    before and read just after: (loss, grads, {kernel: launches}).  Raises
    unless exactly the mode's kernels (`expected`) ran."""
    cs = counters()
    for c in cs:
        for k in c:
            c[k] = 0
    loss, grads = loss_and_grads(model, batch, mode)
    torch.cuda.synchronize()
    launches = {k: v for c in cs for k, v in c.items() if v}
    want = expected(mode, model.joint.pre.out_features)
    if set(launches) != set(want):
        raise AssertionError(f"train step {mode} launched {launches}, its"
                             f" kernels are {want}")
    return loss, grads, launches


def compare_grads(ref, got, tag):
    """Loss and each gradient of ``got`` against ``ref`` ((loss, grads)
    pairs): every value of both finite, loss rtol 2e-3, each gradient within rtol
    0.1 and atol 3e-2 of its largest entry.  Returns the largest error
    over its allowance (<= 1 passes); raises on a failure."""
    (l_ref, g_ref), (l_got, g_got) = ref, got
    l_ref, l_got = float(l_ref), float(l_got)
    if not (np.isfinite(l_ref) and np.isfinite(l_got)
            and abs(l_got - l_ref) <= LOSS_RTOL * abs(l_ref)):
        raise AssertionError(f"{tag}: loss {l_got} against {l_ref}")
    worst = 0.0
    for name, r in g_ref.items():
        r = r.float().cpu()
        k = g_got[name].float().cpu()
        if not (torch.isfinite(r).all() and torch.isfinite(k).all()):
            raise AssertionError(f"{tag}: {name} gradient is not finite")
        atol = max(GRAD_REL_ATOL * r.abs().max().item(), 1e-5)
        err = (k - r).abs()
        if (err > atol + GRAD_RTOL * r.abs()).any():
            raise AssertionError(f"{tag}: {name} gradient off by"
                                 f" {err.max().item()} (atol {atol})")
        worst = max(worst, (err / (atol + GRAD_RTOL * r.abs())).max().item())
    return worst


@contextlib.contextmanager
def recorded_lattice():
    """Inside the block, each lattice sweep on the card is recorded: yields
    a list that gains (blank, emit, xn, yn, fastemit_lambda, the kernel's
    (costs, g_blank, g_emit, alphas, betas)) at each call of
    `cuda_impl.forward_backward`, which every loss mode's core reaches."""
    from warp_rnnt_tpu_torch.ops import cuda_impl

    calls, kernel = [], cuda_impl.forward_backward

    def record(blank, emit, xn, yn, fastemit_lambda=0.0, grads=None):
        out = kernel(blank, emit, xn, yn, fastemit_lambda, grads)
        calls.append((blank.detach().float(), emit.detach().float(), xn, yn,
                      fastemit_lambda, tuple(x.detach() for x in out)))
        return out

    cuda_impl.forward_backward = record
    try:
        yield calls
    finally:
        cuda_impl.forward_backward = kernel


def lattice_matches_plain(call, tag):
    """A `recorded_lattice` call against `cuda_impl.alpha_beta_plain` in
    float64 and the same postprocess on the same inputs: alphas and betas
    on valid cells within 1e-5 |p| + 1e-5, costs rtol 1e-5, gradients
    within 5e-3 of their largest, all finite.  Returns the largest absolute
    error of the alphas and betas on valid cells; raises on a failure."""
    from warp_rnnt_tpu_torch.functional.postprocess import costs_and_grads
    from warp_rnnt_tpu_torch.ops import cuda_impl

    blank, emit, xn, yn, lam, (costs, g_blank, g_emit, alphas, betas) = call
    f64 = torch.float64
    p_alphas, p_betas = cuda_impl.alpha_beta_plain(blank, emit, xn, yn,
                                                   dtype=f64)
    p_costs, p_gb, p_ge = costs_and_grads(blank.to(f64), emit.to(f64),
                                          p_alphas, p_betas, xn, yn, lam)
    T, U = blank.shape[1:]
    valid = ((torch.arange(T, device=xn.device)[None, :, None] < xn[:, None, None])
             & (torch.arange(U, device=xn.device)[None, None, :]
                <= yn[:, None, None]))
    err = 0.0
    for name, k, p in (("alphas", alphas, p_alphas), ("betas", betas, p_betas)):
        k, p = k[valid].to(f64), p[valid]
        diff = (k - p).abs()
        if not (diff <= LATTICE_TOL * p.abs() + LATTICE_TOL).all():
            raise AssertionError(f"{tag}: lattice {name} off the plain version"
                                 f" by {float(diff.max())}")
        err = max(err, float(diff.max()))
    cost_err = ((costs.to(f64) - p_costs).abs() / p_costs.abs()).max()
    if not cost_err <= COST_RTOL:
        raise AssertionError(f"{tag}: lattice costs off by {float(cost_err)}"
                             " relative")
    for k, p in ((g_blank, p_gb), (g_emit, p_ge)):
        diff = (k.to(f64) - p).abs().max()
        if not diff <= LATTICE_GRAD_TOL * p.abs().max():
            raise AssertionError(f"{tag}: lattice gradients off by"
                                 f" {float(diff)}")
    return err


def compare_steps(ref_model, got_model, tag):
    """The parameters of two models after one AdamW step (lr `LR`) from the
    same parameters, each beside the gradient its step used (``.grad``).
    Where both gradients share a sign and exceed `STEP_GRAD_MIN`, or are
    both 0, the two steps agree within `STEP_ATOL`; elsewhere a tiny
    gradient's sign may differ, and the two lie within 2 lr + `STEP_ATOL`.
    Every parameter must be finite.  Returns (the largest difference where
    the gradients agree, the share of entries there); raises on a failure."""
    got = dict(got_model.named_parameters())
    worst, agreed, total = 0.0, 0, 0
    for name, r in ref_model.named_parameters():
        k = got[name]
        r_g, k_g = r.grad.float().cpu(), k.grad.float().cpu()
        agree = (((r_g.sign() == k_g.sign()) & (r_g.abs() > STEP_GRAD_MIN)
                  & (k_g.abs() > STEP_GRAD_MIN)) | ((r_g == 0) & (k_g == 0)))
        diff = (k.detach().float().cpu() - r.detach().float().cpu()).abs()
        bound = torch.where(agree, STEP_ATOL, 2 * LR + STEP_ATOL)
        if not (diff <= bound).all():  # a NaN or an infinity fails here
            raise AssertionError(f"{tag}: {name} after one AdamW step off by"
                                 f" {float(diff.max())}")
        if agree.any():
            worst = max(worst, float(diff[agree].max()))
        agreed += int(agree.sum())
        total += agree.numel()
    return worst, agreed / total


def card_matches_cpu(mode):
    """One train step of the same model at `SMALL` on the card and on the
    CPU (the port's plain versions), in ``mode``.  Returns (largest
    gradient error over its allowance, `compare_steps`' (largest parameter
    difference where the gradients agree, their share), the card's
    launches)."""
    d = SMALL
    cpu_model, _, cpu_batch = init_model(
        3, vocab_size=d["V"], feat_dim=d["F"], N=d["N"], T=d["T"], U=d["U"],
        device="cpu", encoder_hidden=d["H"], predictor_hidden=d["H"],
        joint_hidden=d["H"])
    card_model = copy.deepcopy(cpu_model).to("cuda")
    card_batch = tuple(x.to("cuda") for x in cpu_batch)
    cpu = loss_and_grads(cpu_model, cpu_batch, mode)
    loss, grads, launches = launches_per_step(card_model, card_batch, mode)
    worst = compare_grads(cpu, (loss, grads), f"card vs cpu {mode}")
    for model, batch in ((cpu_model, cpu_batch), (card_model, card_batch)):
        opt = torch.optim.AdamW(model.parameters(), lr=LR,
                                weight_decay=WEIGHT_DECAY)
        make_train_step(model, opt, loss_mode=mode)(batch)
    steps = compare_steps(cpu_model, card_model, f"card vs cpu {mode}")
    return worst, steps, launches
