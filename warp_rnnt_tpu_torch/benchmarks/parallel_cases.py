"""The parallel tier on the card: its cases and checks, shared by
`chip_smoke.py` (phase 16) and the `cuda`-marked tests of
`tests/test_torch_parallel_card.py`.  Each check raises AssertionError on a
failure and returns what it measured.

  * `compare_shards`: the vocabulary-shard kernels (`gather_lattice` and
    `flat_grad_write` with a column offset) against their plain twins,
    exactly, on each half of a vocabulary split in two (also at a rank's
    shape in the 2x2 world's main path); the halves' lattices sum to the
    whole gather and their writes put together equal the whole write,
    exactly.
  * `check_main_1rank`: `rnnt_loss_sharded` and `rnnt_loss_shard_map`
    ("mean", backward; "none") on a 1-rank mesh against
    `rnnt_loss(gather=True)`: costs and the gradient bit for bit.
  * `check_train_step`: one `make_sharded_train_step` step against the
    single-process step (`train_cases.compare_grads`, `compare_steps`).
    On a mesh that does not split the vocabulary (1x1 over NCCL) the step
    takes the single-process loss, so the vocabulary-parallel route's
    loss and gradients are checked by a call of its own.
  * `run_world` spawns `world_main` in 4 processes that share one card
    over gloo (2x2 mesh; the kernels on the card, the collectives through
    the host): the main path at full width with the log-probs split over
    'data' (16 samples a rank) and 'model' (2500 columns) against the
    single-process call (costs and mean rtol 1e-6, each rank's gradient
    block exactly), compact case A (the lattice bounds left to
    `rnnt_loss_sharded`, which takes the global ones) and the restricted loss (bands 15/5, two infeasible samples on
    data rank 0) over 'data' (means rtol 1e-6, gradients 1e-6 of the
    largest), `dryrun_multichip(4)`, and one "from_logits" train step at
    `bench_train.py`'s width against the single-process step.  The
    collectives' time there is the host's and is not a measurement.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import torch

from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.benchmarks.packed_cases import full_case
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.functional.restricted import rnnt_loss_restricted
from warp_rnnt_tpu_torch.models import make_train_step
from warp_rnnt_tpu_torch.ops import flat_kernels as fk
from warp_rnnt_tpu_torch.ops import gather_kernels as gk
from warp_rnnt_tpu_torch.parallel import (
    make_mesh,
    rnnt_loss_shard_map,
    rnnt_loss_sharded,
    shard_batch,
)
from warp_rnnt_tpu_torch.parallel.loss_parallel import shard_packed
from warp_rnnt_tpu_torch.parallel.multihost import spawn
from warp_rnnt_tpu_torch.parallel.train_parallel import (
    _vocab_parallel_loss,
    make_sharded_train_step,
    shard_model,
    splits_vocab,
)
from warp_rnnt_tpu_torch.parallel.vocab import shard_vocab

MAIN = dict(N=32, T=150, U=21, V=5000)
CASE_A = dict(N=32, T=150, L=20, V=5000)
SEED = 0
MAIN_PATH = ("gather_lattice", "lattice_fused", "flat_write")
# The vocabulary-shard cases: (N, T, U, V, blank, dtype), V split in two.
# Labels fall on both sides of V/2; the blank lies in the first block, in
# the second, and on its first column.
SHARD_CASES = {
    "V=5000 blank 0": (4, 150, 21, 5000, 0, torch.float32),
    "V=5000 blank 3000": (4, 150, 21, 5000, 3000, torch.float32),
    "V=5000 blank 2500": (2, 37, 21, 5000, 2500, torch.float32),
    "V=130 bf16 blank 1": (3, 13, 5, 130, 1, torch.bfloat16),
    # a rank of the 2x2 world's main path: 16 samples, 2500 columns
    "2x2 rank, V=5000 blank 0": (16, 150, 21, 5000, 0, torch.float32),
}


def reset():
    for c in sc.counters():
        for k in c:
            c[k] = 0


def launched():
    torch.cuda.synchronize()
    return {k: v for c in sc.counters() for k, v in c.items() if v}


def make_inputs(N, T, U, V, seed, device="cuda"):
    """`chip_smoke.py`'s main-path inputs: seeded log_softmax log-probs,
    labels in [1, V), full lengths."""
    g = torch.Generator(device=device).manual_seed(seed)
    log_probs = torch.log_softmax(
        torch.randn(N, T, U, V, generator=g, device=device), dim=-1)
    labels = torch.randint(1, V, (N, U - 1), generator=g, device=device,
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device=device)
    yn = torch.full((N,), U - 1, dtype=torch.int32, device=device)
    return log_probs, labels, xn, yn


def shard_case(N, T, U, V, blank, dtype, seed=0, device="cuda"):
    """xs (N, T, U, V), labels_ext (N, U) on both sides of V/2 (the last
    row the blank), fp32 cotangents (N, T, U); the tensors drawn on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn(N, T, U, V, generator=g, device=device).to(dtype)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, V, (N, U))
    labels[:, 0] = V // 2 - 1
    labels[:, 1] = V // 2
    labels[:, -1] = blank
    f32 = dict(dtype=torch.float32, device=device)
    return dict(xs=xs, blank=blank,
                labels_ext=torch.tensor(labels, dtype=torch.int32,
                                        device=device),
                ct_b=torch.randn(N, T, U, generator=g, **f32),
                ct_l=torch.randn(N, T, U, generator=g, **f32))


def _exact(name, got, want):
    """max |got - want| (equal entries count 0, infinities too); raises
    unless the tensors are equal."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against"
                             f" {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs().masked_fill_(got == want, 0)
    err = float(diff.max()) if diff.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs by up to {err}")
    return err


def compare_shards(case):
    """The shard kernels on each half of the case's vocabulary against
    their plain twins, and the halves against the whole.  Returns
    {kernel: max abs err against its twin}, measured (0.0: they must be
    exact)."""
    xs, lab, blank = case["xs"], case["labels_ext"], case["blank"]
    N, T, U, V = xs.shape
    half = V // 2
    whole = gk.gather_lattice(xs, lab, blank)
    dtype = xs.dtype
    whole_w = fk.flat_grad_write(case["ct_b"], case["ct_l"], lab, blank, V,
                                 U * V, dtype).view(N, T, U, V)
    total, writes = torch.zeros_like(whole), []
    errs = {"gather_lattice": 0.0, "flat_write": 0.0}
    for off in (0, half):
        block = xs[..., off:off + half].contiguous()
        got = gk.gather_lattice(block, lab, blank, offset=off)
        errs["gather_lattice"] = max(errs["gather_lattice"], _exact(
            f"gather offset {off}", got,
            gk.gather_lattice_plain(block, lab, blank, offset=off)))
        total += got
        del block
        args = (case["ct_b"], case["ct_l"], lab, blank, half, U * half, dtype)
        w = fk.flat_grad_write(*args, offset=off)
        errs["flat_write"] = max(errs["flat_write"], _exact(
            f"write offset {off}", w,
            fk.flat_grad_write_plain(*args, offset=off)))
        writes.append(w.view(N, T, U, half))
    _exact("halves' lattices against the whole", total, whole)
    _exact("halves' writes against the whole", torch.cat(writes, -1), whole_w)
    return errs


def _rel(got, want):
    """max |got - want| over max |want| (NaN fails every bound)."""
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _loss_grad(fn, x):
    x = x.detach().requires_grad_()
    loss = fn(x)
    loss.backward()
    return loss.detach(), x.grad


def check_main_1rank(mesh, inputs):
    """On a 1-rank ('data',) mesh: `rnnt_loss_sharded` and
    `rnnt_loss_shard_map` ("mean" with backward, "none") against
    `rnnt_loss(gather=True)`.  Costs and gradients must be bit-equal; the
    means (a sum divided by the count against `mean`) within rtol 1e-6.
    Returns (launches of the sharded calls, counted from 0 just before,
    {check: error})."""
    lp, labels, xn, yn = inputs
    ref, ref_g = _loss_grad(lambda x: rnnt_loss(
        x, labels, xn, yn, reduction="mean", gather=True), lp)
    ref_costs = rnnt_loss(lp, labels, xn, yn, gather=True)
    reset()
    out = {}
    for name, fn in (("sharded", rnnt_loss_sharded),
                     ("shard_map", rnnt_loss_shard_map)):
        loss, grad = _loss_grad(lambda x: fn(
            mesh, x, labels, xn, yn, reduction="mean", gather=True), lp)
        with torch.no_grad():
            costs = fn(mesh, lp, labels, xn, yn, reduction="none",
                       gather=True)
        if not torch.equal(costs, ref_costs):
            raise AssertionError(f"{name}: costs differ from rnnt_loss")
        if not torch.equal(grad, ref_g):
            raise AssertionError(f"{name}: gradient differs from rnnt_loss")
        out[f"{name}_mean_rel_err"] = _rel(loss, ref)
        if not out[f"{name}_mean_rel_err"] <= 1e-6:
            raise AssertionError(f"{name}: mean {float(loss)} against"
                                 f" {float(ref)}")
        del grad
    launches = launched()
    missing = [k for k in MAIN_PATH if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"sharded main path launched {launches}")
    return launches, out


def _block_copy(model, mesh):
    """A copy of a single-process model after its step, with its gradients,
    the out projection (values and gradients) cut to this rank's
    vocabulary block."""
    from warp_rnnt_tpu_torch.parallel.vocab import mesh_vocab_block

    m = copy.deepcopy(model)
    for q, p in zip(m.parameters(), model.parameters()):
        q.grad = p.grad.clone()
    out = m.joint.out
    lo, width = mesh_vocab_block(mesh, out.out_features)
    for name in ("weight", "bias"):
        p = getattr(model.joint.out, name)
        q = torch.nn.Parameter(p.detach()[lo:lo + width].clone())
        q.grad = p.grad[lo:lo + width].clone()
        setattr(out, name, q)
    return m


def check_train_step(mesh, mode, dims=tc.FULL, seed=SEED + 41,
                     device="cuda"):
    """One `make_sharded_train_step` step over ``mesh`` (this rank's block
    of the batch and, where the mesh splits the vocabulary, of the out
    projection) against one single-process `make_train_step` step from the
    same carried model: loss and gradients by `train_cases.compare_grads`,
    the parameters after the AdamW step by `compare_steps`.  Where the mesh
    does not split the vocabulary, the step takes the single-process loss,
    so the vocabulary-parallel route (`_vocab_parallel_loss`) is also run
    on its own from the same model and held against the same gradients.
    Returns {"grads": the step's gradients' largest error over their
    allowance, "moved": the largest parameter difference where the
    gradients agree, "step": the sharded step, "batch": its batch,
    "launches": the step's launches, "vocab_grads" and "vocab_launches":
    the route's own call (None where the step took it)}."""
    model, batch = tc.carried(seed, dims, device)
    ref = copy.deepcopy(model)
    opt = torch.optim.AdamW(ref.parameters(), lr=tc.LR,
                            weight_decay=tc.WEIGHT_DECAY)
    ref_loss = make_train_step(ref, opt, loss_mode=mode)(batch)
    shard_model(model, mesh)
    local = shard_batch(mesh, batch)
    block = _block_copy(ref, mesh)
    ref_grads = (ref_loss, {k: p.grad for k, p in block.named_parameters()})
    out = {"vocab_grads": None, "vocab_launches": None}
    if not splits_vocab(mesh):
        route = copy.deepcopy(model)
        reset()
        loss = _vocab_parallel_loss(route, local, mesh, 0.0, mode)
        loss.backward()
        out["vocab_launches"] = launched()
        out["vocab_grads"] = tc.compare_grads(
            ref_grads,
            (loss.detach(),
             {k: p.grad for k, p in route.named_parameters()}),
            f"vocabulary route {mode}")
        del route, loss
    opt = torch.optim.AdamW(model.parameters(), lr=tc.LR,
                            weight_decay=tc.WEIGHT_DECAY)
    step = make_sharded_train_step(model, opt, mesh, loss_mode=mode)
    reset()
    loss = step(local)
    out["launches"] = launched()
    out["grads"] = tc.compare_grads(
        ref_grads, (loss, {k: p.grad for k, p in model.named_parameters()}),
        f"sharded train {mode}")
    out["moved"], _ = tc.compare_steps(block, model, f"sharded train {mode}")
    del ref, block
    return {**out, "step": step, "batch": local}


def world_main(rank, device, out_dir):
    """One rank of the 2x2 gloo world (`run_world`); writes
    ``out_dir/rank{rank}.json``."""
    from warp_rnnt_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    res = {"launches": {}, "errs": {}, "s": {}}
    t0 = time.perf_counter()

    lp, labels, xn, yn = make_inputs(**MAIN, seed=SEED)
    ref, ref_g = _loss_grad(lambda x: rnnt_loss(
        x, labels, xn, yn, reduction="mean", gather=True), lp)
    ref_costs = rnnt_loss(lp, labels, xn, yn, gather=True)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = slice(16 * d, 16 * (d + 1))
    cols = slice(2500 * m, 2500 * (m + 1))
    lp_l, lab_l, xn_l, yn_l = shard_batch(mesh, (lp, labels, xn, yn))
    lp_l = shard_vocab(mesh, lp_l)
    del lp
    reset()
    loss, grad = _loss_grad(lambda x: rnnt_loss_sharded(
        mesh, x, lab_l, xn_l, yn_l, reduction="mean", vocab_axis="model"),
        lp_l)
    with torch.no_grad():
        costs = rnnt_loss_sharded(mesh, lp_l, lab_l, xn_l, yn_l,
                                  reduction="none", vocab_axis="model")
    res["launches"]["main"] = launched()
    if not torch.allclose(costs, ref_costs[rows], rtol=1e-6, atol=0):
        raise AssertionError("2x2 main path: costs differ")
    res["errs"]["main_mean_rel"] = _rel(loss, ref)
    if not res["errs"]["main_mean_rel"] <= 1e-6:
        raise AssertionError(f"2x2 main path: mean {float(loss)} against"
                             f" {float(ref)}")
    if not torch.equal(grad, ref_g[rows][..., cols]):
        raise AssertionError("2x2 main path: gradient block differs")
    del ref_g, grad, lp_l
    res["s"]["main"] = time.perf_counter() - t0

    c = full_case(**CASE_A, seed=SEED)
    xs, ys, cxn, cyn = c["xs"], c["ys"], c["xn"], c["yn"]
    # no lattice bounds: rnnt_loss_sharded takes the global batch's, as the
    # single-process call does
    ref, ref_g = _loss_grad(lambda x: rnnt_loss(
        x, ys, cxn, cyn, reduction="mean", compact=True), xs)
    xs_l, ys_l, xn_l, yn_l = shard_packed(mesh, xs, ys, cxn, cyn)
    first = int((cxn[:16 * d].long() * (cyn[:16 * d].long() + 1)).sum())
    reset()
    loss, grad = _loss_grad(lambda x: rnnt_loss_sharded(
        mesh, x, ys_l, xn_l, yn_l, reduction="mean", compact=True), xs_l)
    res["launches"]["compact_A"] = launched()
    want = ref_g[first:first + xs_l.shape[0]]
    res["errs"]["compact_mean_rel"] = _rel(loss, ref)
    res["errs"]["compact_grad"] = _rel(grad, want)
    if not (res["errs"]["compact_mean_rel"] <= 1e-6
            and res["errs"]["compact_grad"] <= 1e-6):
        raise AssertionError(f"2x2 compact A: {res['errs']}")
    del c, xs, ref_g, grad

    lp, labels, xn, yn, frames = sc.restricted_inputs(SEED + 51, **MAIN)
    frames = sc.out_of_order(frames)
    band = dict(left_context=sc.LEFT, right_context=sc.RIGHT)
    ref, ref_g = _loss_grad(lambda x: rnnt_loss_restricted(
        x, labels, xn, yn, frames, reduction="mean", **band), lp)
    lp_l, lab_l, xn_l, yn_l, fr_l = shard_batch(
        mesh, (lp, labels, xn, yn, frames))
    del lp
    reset()
    loss, grad = _loss_grad(lambda x: rnnt_loss_sharded(
        mesh, x, lab_l, xn_l, yn_l, reduction="mean", label_frames=fr_l,
        **band), lp_l)
    res["launches"]["restricted"] = launched()
    res["errs"]["restricted_mean_rel"] = _rel(loss, ref)
    res["errs"]["restricted_grad"] = _rel(grad, ref_g[rows])
    if not (res["errs"]["restricted_mean_rel"] <= 1e-6
            and res["errs"]["restricted_grad"] <= 1e-6):
        raise AssertionError(f"2x2 restricted: {res['errs']}")
    del ref_g, grad, lp_l
    torch.cuda.empty_cache()
    res["s"]["losses"] = time.perf_counter() - t0

    reset()
    res["dryrun"] = dryrun_multichip(4, device, verbose=False)
    res["launches"]["dryrun"] = launched()
    res["s"]["dryrun"] = time.perf_counter() - t0

    r = check_train_step(mesh, "from_logits")
    res["launches"]["train_from_logits"] = r["launches"]
    res["errs"]["train_grads_share"] = r["grads"]
    res["errs"]["train_step_share"] = r["moved"] / tc.STEP_ATOL
    del r
    res["s"]["train"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_world(out_dir, world=4, timeout=240.0):
    """`world_main` in ``world`` processes on ``cuda:0`` over gloo
    (`multihost.spawn`: a failed rank, or ``timeout`` seconds, kills every
    process and raises).  Returns the ranks' results."""
    spawn(world_main, world, (out_dir,), backend="gloo", device="cuda:0",
          timeout=timeout)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results
