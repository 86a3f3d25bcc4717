"""The compiled train step and the compiled compact loss, checked against
their eager calls: `chip_smoke.py` (`phase_compiled_train`) runs these at
`bench_train`'s width and at compact cases A and B, and
`tests/test_torch_compiled_train_card.py` at small ones; on CPU tensors
both sides run eagerly, which the CPU tests use to run this code.  Each
check raises an AssertionError on a failure.

  * `check_train`: in one loss mode, from a fresh model and a fresh
    optimizer each, `models.compiled_train_step` against the same step
    run eagerly (`compiled_step._plain`, the same ``capturable=True``
    AdamW): after the first call (which captures, so its warm-up must
    leave no trace) and after ``K`` calls, the losses, the parameters and
    AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` are equal bit for
    bit.  Where two eager runs of the same steps differ (a library's
    backward summing with atomics), the compiled step is held within
    `train_cases.compare_steps`' tolerance instead, and the tensors that
    differ between the two eager runs are named.  The loss falls over
    the calls.  Then the compiled step after one call against one eager
    step of the optimizer as `bench_train` builds it eagerly (not
    capturable), within `train_cases.STEP_ATOL` where the two gradients
    agree (`compare_steps`).
  * `check_compact`: `rnnt_loss(compact=True, reduction="mean")` + backward
    and the no-grad costs, each compiled once a shape with static bounds
    (`packed_step.compiled_steps`), against the eager calls without bounds
    (the read of the lengths the capture leaves out), bit for bit: the
    loss, the packed gradient and the costs; on the card the kernels of
    each replay and of the eager call under the profiler.
"""

from __future__ import annotations

import math

import torch

from warp_rnnt_tpu_torch.benchmarks import packed_step
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.models import make_train_step
from warp_rnnt_tpu_torch.models.transducer import compiled_train_step
from warp_rnnt_tpu_torch.utils import compiled_step as cs


def adamw(model, capturable):
    """`bench_train`'s optimizer, ``optax.adamw(1e-3)``'s update."""
    return torch.optim.AdamW(model.parameters(), lr=tc.LR,
                             weight_decay=tc.WEIGHT_DECAY,
                             capturable=capturable)


def named_state(model, opt):
    """{name: a copy} of every parameter and its AdamW state tensors."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.detach().clone()
        for k, v in opt.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                out[f"{name}/{k}"] = v.detach().clone()
    return out


def differing(a, b):
    """The names whose tensors differ between two `named_state`s (or whose
    sets differ)."""
    names = sorted(set(a) | set(b))
    return [n for n in names
            if n not in a or n not in b or not torch.equal(a[n], b[n])]


def _run(model, batch, step, K):
    """K calls of ``step``: (losses, {1: named_state, K: named_state})."""
    losses, states = [], {}
    for k in range(1, K + 1):
        losses.append(step(batch).detach().clone())
        if k in (1, K):
            states[k] = named_state(model, step.opt)
    return losses, states


def _train_step(model, mode, capturable, compiled):
    opt = adamw(model, capturable)
    if compiled:
        step = compiled_train_step(model, opt, loss_mode=mode)
    else:
        step = make_train_step(model, opt, loss_mode=mode)
    step.opt = opt
    return step


def check_train(mode, dims=tc.FULL, seed=0, K=5, device="cuda"):
    """`check_train` of the module docstring.  Returns {"losses" (the
    compiled calls'), "bit_for_bit", "eager_differs" (names differing
    between two eager runs, empty where they are bit for bit),
    "worst_step" (compare_steps' largest difference where the gradients
    agree, against the other eager run's, where not bit for bit),
    "vs_non_capturable" ([largest difference where the gradients agree,
    their share]), and on the card "capture_ms", "pool_mib"}."""
    on_card = torch.device(device).type == "cuda"
    eager = []
    for _ in range(2):
        model, batch = tc.carried(seed, dims, device=device)
        with cs._plain():
            step = _train_step(model, mode, on_card, compiled=True)
            eager.append(_run(model, batch, step, K) + (model,))
        del step
    model, batch = tc.carried(seed, dims, device=device)
    step = _train_step(model, mode, on_card, compiled=True)
    out = {}
    try:
        losses, first = [step(batch).detach().clone()], named_state(
            model, step.opt)
        entry = step.compiled.entry
        if entry is not None:
            out["capture_ms"] = entry.capture_ms
            out["pool_mib"] = entry.pool_bytes / 2**20
        ref, _ = tc.carried(seed, dims, device=device)
        plain = _train_step(ref, mode, False, compiled=False)
        plain(batch)
        out["vs_non_capturable"] = list(tc.compare_steps(
            ref, model, f"compiled {mode} vs the non-capturable eager step"))
        del ref, plain
        for _ in range(K - 1):
            losses.append(step(batch).detach().clone())
        last = named_state(model, step.opt)
    finally:
        step.compiled.release()
    (l_a, s_a, m_a), (l_b, s_b, _) = eager
    odd = sorted(set(differing(s_a[1], s_b[1])) | set(differing(s_a[K],
                                                                s_b[K])))
    odd += [f"loss {k + 1}" for k, (a, b) in enumerate(zip(l_a, l_b))
            if not torch.equal(a, b)]
    out["eager_differs"] = odd
    got = {1: first, K: last}
    if not odd:
        for k in (1, K):
            bad = differing(s_a[k], got[k])
            if bad:
                raise AssertionError(f"compiled {mode} after {k} calls differs"
                                     f" from the eager steps in {bad[:8]}")
        bad = [k + 1 for k, (a, b) in enumerate(zip(l_a, losses))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"compiled {mode}: losses of calls {bad}"
                                 f" differ from eager {l_a} {losses}")
    else:
        # held as two eager runs are held: within compare_steps' tolerance
        out["worst_step"] = tc.compare_steps(m_a, model,
                                             f"compiled {mode} after {K}")[0]
    out["bit_for_bit"] = not odd
    out["losses"] = [float(x) for x in losses]
    if not all(map(math.isfinite, out["losses"])) or (
            out["losses"][-1] >= out["losses"][0]):
        raise AssertionError(f"compiled {mode}: the loss did not fall"
                             f" {out['losses']}")
    return out


def _replay_kernels(call):
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile

    call()
    torch.cuda.synchronize()
    r = device_profile(call, 10)
    return {key: n for _, n, key in r["rows"]}, r["busy_ms"]


def check_compact(case):
    """`check_compact` of the module docstring on a `packed_cases` case.
    Returns {"capture_ms", "pool_mib" (each {"loss_grad", "no_grad"}),
    "kernels" ({"loss_grad", "no_grad", "eager"}: {kernel: launches a
    call}), "busy_ms" (likewise)}; on CPU tensors {} (both sides eager)."""
    xs = case["xs"]
    grad_step, costs_step = packed_step.compiled_steps(case)
    eager_grad = packed_step.loss_grad_step(case)
    eager_costs = packed_step.costs_step(case)
    out = {}
    try:
        got = (*grad_step(xs), *costs_step(xs))
        want = (*eager_grad(xs), *eager_costs(xs))
        for name, a, b in zip(("loss", "packed gradient", "costs"), got,
                              want):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                    a, b):
                err = (a.double() - b.double()).abs().max().item()
                raise AssertionError(f"compact compiled {name} differs from"
                                     f" eager (max abs err {err})")
        if not all(torch.isfinite(t).all() for t in (got[0], got[2])):
            raise AssertionError("compact compiled: not finite")
        if grad_step.entry is None:
            return out
        out["capture_ms"] = {"loss_grad": grad_step.entry.capture_ms,
                             "no_grad": costs_step.entry.capture_ms}
        out["pool_mib"] = {"loss_grad": grad_step.entry.pool_bytes / 2**20,
                           "no_grad": costs_step.entry.pool_bytes / 2**20}
        kernels, busy = {}, {}
        for name, call in (
                ("loss_grad", lambda: grad_step(*grad_step.entry.args)),
                ("no_grad", lambda: costs_step(*costs_step.entry.args)),
                ("eager", lambda: eager_grad(xs))):
            kernels[name], busy[name] = _replay_kernels(call)
        out["kernels"], out["busy_ms"] = kernels, busy
    finally:
        grad_step.release()
        costs_step.release()
    return out
