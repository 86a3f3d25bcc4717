"""The compiled AdamW train step of the port's `Transducer`:
`models.transducer.compiled_train_step`, the whole step (loss, backward,
update) one CUDA graph a batch shape, each call fed one batch of the pool,
copied into the graph's inputs.

Set-up makes the weights and the pool from the seed on the card, builds
one model, one AdamW (capturable) and one compiled step, and drives that
step through its first three steps on the pool's first three batches (the
first call captures and applies exactly one update); the window goes on
with the same object on the batches after them, in turn.

Check, against the plain reference (`reference.transducer`), at two
stages.  The start: the reference follows those three steps from the
same weights.  ``loss_rel_err``: the largest relative gap of a step's
loss.  ``grad_norm_gap``: the first step's gradient, read from AdamW's
first moment after one step (m = (1 - beta1) g), leaf by leaf: the
largest |norm(program) - norm(reference)| over max(the reference leaf's
norm, the median leaf's).  ``change_norm_gap``: the same of each leaf's
change after the three steps.  After the window: the same object takes
two more steps through the window's call on the batches that come next,
and the reference takes them from the program's weights and moments as
the window left them (it cannot redo the window's steps in less time
than the window), with its own count of the steps taken, so that a count
or a bias correction frozen in the graph shows.  ``after_loss_rel_err``: their losses' largest
relative gap; ``after_change_gap``: the gap of each leaf's change over
the two steps, as ``change_norm_gap``; ``after_moment_gap``: the same of
each leaf's first moment after them.  Leaves whose reference gradient
norm is under a thousandth of the median leaf's are left out (their
moves are round-off under Adam).
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import counts, traffic
from portbench.reference import transducer as ref

STEPS = 3  # the steps the reference follows from the start
AFTER = 2  # the steps it follows after the window


def port_step(config, device):
    """(model, optimizer, step) of the program, its weights empty."""
    from warp_rnnt_tpu_torch.models.transducer import (Transducer,
                                                       compiled_train_step)

    c = config
    # built on the device (its own initialisation, overwritten by the
    # benchmark's weights): a model on "meta" first costs seconds of
    # torch's imports at set-up
    model = Transducer(c["vocab"], c["hidden"], c["hidden"], c["joint"],
                       c["joint_mode"], c["feat_dim"], torch.bfloat16,
                       device=device)
    opt = torch.optim.AdamW(model.parameters(), lr=c["lr"],
                            betas=tuple(c["betas"]), eps=c["eps"],
                            weight_decay=c["weight_decay"],
                            capturable=device == "cuda")
    step = compiled_train_step(model, opt, loss_mode=c["loss_mode"])
    return model, opt, step


def control(config):
    """The control: the reference in the program's place with the inputs
    of its bf16 products rounded through float8, the precision below the
    configuration's bf16 products."""
    def wrap(step):
        return _ReferenceStep(step.cell, ref.fp8)
    return wrap


class _ReferenceStep:
    """The plain reference as the train step: it writes its weights into
    the cell's model and its first moments into the cell's AdamW state, so
    that the check reads them as it reads the program's."""

    def __init__(self, cell, quant):
        self.cell = cell
        self.trainer = ref.Trainer(
            {k: p.detach() for k, p in cell.model.named_parameters()},
            cell.config, quant)

    def __call__(self, batch):
        value = self.trainer.step(batch)
        with torch.no_grad():
            for k, p in self.cell.model.named_parameters():
                p.copy_(self.trainer.w[k])
                st = self.cell.opt.state.setdefault(p, {})
                st["exp_avg"] = self.trainer.m[k].clone()
                st["exp_avg_sq"] = self.trainer.v[k].clone()
        return torch.tensor(value)


def _unchanged(step):
    """A step that returns its loss and leaves the state as it was."""
    def f(batch):
        cell = step.cell
        saved = [t.detach().clone() for t in cell.state()]
        loss = step(batch)
        with torch.no_grad():
            for t, s in zip(cell.state(), saved):
                t.copy_(s)
        return loss
    f.cell = step.cell
    return f


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest: the step
    fed the first half of each batch, its rows repeated."""
    def f(batch):
        h = batch[0].shape[0] // 2
        return step(tuple(torch.cat([x[:h], x[:h]]) for x in batch))
    f.cell = step.cell
    return f


def _loss_altered(step):
    """The loss altered where it is produced."""
    def f(batch):
        return step(batch) * 1.001
    f.cell = step.cell
    return f


def _count_frozen(step):
    """The optimizer's step count frozen after the first three steps: every
    later step's bias correction is that of step 4."""
    calls = []

    def f(batch):
        if len(calls) >= STEPS:
            for st in step.cell.opt.state.values():
                st["step"].fill_(STEPS)
        calls.append(1)
        return step(batch)
    f.cell = step.cell
    return f


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "loss_altered": _loss_altered, "count_frozen": _count_frozen}


class Cell:
    def __init__(self, config, mix, seed, device, wrap=None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.wrap = wrap
        self.units = int(mix["N"])
        self.limits = mix["limits"]

    def state(self):
        out = [p for p in self.model.parameters()]
        for st in self.opt.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return out

    def setup(self):
        t0 = time.time()
        gen = traffic.generator(self.seed, self.device)
        self.w0 = ref.init_weights(self.config, gen, self.device)
        self.pool = traffic.pool(self.mix, gen, self.device)
        self.valid = [counts.valid_cells(b["xn"].tolist(), b["yn"].tolist())
                      for b in self.pool]
        self.model, self.opt, step = port_step(self.config, self.device)
        names = {k for k, _ in self.model.named_parameters()}
        if names != set(self.w0):
            raise ValueError(f"weights {sorted(set(self.w0) ^ names)} match"
                             " no parameter of the program's model")
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.w0[k])
        step.cell = self
        self.step = step
        self.program = self.wrap(step) if self.wrap else step
        self.losses, self.used = [], []
        b1 = self.config["betas"][0]
        self.phases = {"inputs and model": time.time() - t0}
        for i in range(STEPS):
            t0 = time.time()
            self.losses.append(float(self.call_batch(i)))
            self.phases[f"step {i + 1}"] = time.time() - t0
            if i == 0:
                self.grad1 = {k: self.opt.state[p]["exp_avg"].detach() / (1 - b1)
                              for k, p in self.model.named_parameters()}
        self.w3 = {k: p.detach().clone()
                   for k, p in self.model.named_parameters()}
        self.used = []

    def batch(self, i):
        b = self.pool[i % len(self.pool)]
        return (b["feats"], b["labels"], b["xn"], b["yn"])

    def call_batch(self, i):
        self.used.append(i % len(self.pool))
        return self.program(self.batch(i))

    def call(self, i):
        self.call_batch(i + STEPS)

    def finish(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def context(self):
        c, m = self.config, self.mix
        return {"N": m["N"], "T": m["T"], "U": m["U"], "V": c["vocab"],
                "feat_dim": c["feat_dim"], "hidden": c["hidden"],
                "joint": c["joint"], "blocks": c["blocks"],
                "kernel": c["kernel"], "calls": len(self.used),
                "valid_cells": sum(self.valid[b] for b in self.used)}

    def _moments(self):
        """{name: exp_avg}, {name: exp_avg_sq} of the program's AdamW."""
        m, v = {}, {}
        for k, p in self.model.named_parameters():
            st = self.opt.state.get(p, {})
            if "exp_avg" in st:
                m[k] = st["exp_avg"].detach().clone()
            if "exp_avg_sq" in st:
                v[k] = st["exp_avg_sq"].detach().clone()
        return m, v

    def _after_window(self):
        """AFTER more steps of the same object, through the window's call;
        (steps taken before them, weights and moments before, losses,
        weights and first moments after)."""
        n = STEPS + len(self.used)
        w_a = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        moments = self._moments()
        losses = [float(self.program(self.batch(n + j)))
                  for j in range(AFTER)]
        w_b = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        return n, w_a, moments, losses, w_b, self._moments()[0]

    def check(self):
        n, w_a, moments, after, w_b, m_b = self._after_window()
        compiled = getattr(self.step, "compiled", None)
        if compiled is not None:
            compiled.release()
        del self.model, self.opt, self.program, self.step
        if self.device == "cuda":
            torch.cuda.empty_cache()
        losses, g_ref, w_ref = ref.train(
            self.w0, [self.batch(i) for i in range(STEPS)], self.config)
        loss_err = _rel(self.losses, losses)
        g_norm = {k: float(v.norm()) for k, v in g_ref.items()}
        kept = _kept(g_norm)
        g_med = statistics.median(g_norm.values())
        grad_gap = max(abs(float(self.grad1[k].norm()) - g_norm[k])
                       / max(g_norm[k], g_med) for k in kept)
        change_gap = _gap({k: self.w3[k] - self.w0[k] for k in kept},
                          {k: w_ref[k] - self.w0[k] for k in kept})
        del w_ref, g_ref

        tr = ref.Trainer(w_a, self.config, moments=moments, t=n)
        after_ref = [tr.step(self.batch(n + j)) for j in range(AFTER)]
        after_err = _rel(after, after_ref)
        kept = _kept({k: float(g.norm()) for k, g in tr.first.items()})
        after_change = _gap({k: w_b[k] - w_a[k] for k in kept},
                            {k: tr.w[k].detach() - w_a[k] for k in kept})
        after_moment = _gap({k: m_b[k] for k in kept},
                            {k: tr.m[k] for k in kept})
        lim = self.limits
        failed = (sum(e > lim["loss_rel_err"] or e != e for e in loss_err)
                  + sum(e > lim["after_loss_rel_err"] or e != e
                        for e in after_err))
        return ({"loss_rel_err": (max(loss_err), lim["loss_rel_err"]),
                 "grad_norm_gap": (grad_gap, lim["grad_norm_gap"]),
                 "change_norm_gap": (change_gap, lim["change_norm_gap"]),
                 "after_loss_rel_err": (max(after_err),
                                        lim["after_loss_rel_err"]),
                 "after_change_gap": (after_change,
                                      lim["after_change_gap"]),
                 "after_moment_gap": (after_moment,
                                      lim["after_moment_gap"])},
                failed)


def _rel(values, refs):
    return [abs(p - r) / abs(r) for p, r in zip(values, refs)]


def _kept(g_norm):
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's."""
    g_med = statistics.median(g_norm.values())
    return [k for k, n in g_norm.items() if n >= 1e-3 * g_med]


def _gap(prog, refs):
    """The worst leaf's |norm(program) - norm(reference)| over max(the
    reference leaf's norm, the median leaf's)."""
    p = {k: float(v.norm()) for k, v in prog.items()}
    r = {k: float(v.norm()) for k, v in refs.items()}
    med = statistics.median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in r)
