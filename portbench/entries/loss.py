"""Eager loss and gradient calls of the public `rnnt_loss`, as a training
loop calls it: ``rnnt_loss(log_probs, labels, xn, yn, gather=True)`` on
one fp32 (N, T, U, V) log-prob tensor, then ``costs.sum().backward()``,
the gradient dropped before each call (``zero_grad(set_to_none=True)``).

Traffic: one log-prob tensor and a pool of batches of lengths and labels
(`traffic.pool`), taken in turn, one a call.

Check: every call's costs against the plain reference's costs of its
batch (float64), and the last call's whole dense gradient against the
reference's; ``cost_rel_err`` is the largest |cost - reference| /
|reference| over every utterance of every call, ``grad_abs_err`` the
largest absolute difference over the (N, T, U, V) gradient.  A call
whose costs read above the limit is a failed answer.
"""

from __future__ import annotations

import time

import torch

from portbench import counts, traffic
from portbench.reference import lattice


def port_call(config):
    """The program's call: costs (N,) of one eager loss and gradient."""
    from warp_rnnt_tpu_torch import rnnt_loss

    blank = int(config.get("blank", 0))

    def call(lp, labels, xn, yn):
        costs = rnnt_loss(lp, labels, xn, yn, blank=blank, gather=True)
        costs.sum().backward()
        return costs

    return call


def reference_call(config, dtype):
    """The plain reference computed in ``dtype``, called as the program
    is: the control of the check, in a precision below the
    configuration's."""
    blank = int(config.get("blank", 0))

    def call(lp, labels, xn, yn):
        costs = lattice.Loss.apply(lp, labels, xn, yn, dtype, blank)
        costs.sum().backward()
        return costs

    return call


def control(config):
    """The control: the reference in the program's place, in bfloat16, the
    precision below the configuration's float32 (the loss has no matrix
    product, so TF32 does not apply)."""
    return lambda call: reference_call(config, torch.bfloat16)


def _half_batch(call):
    """Half of the batch left out: the loss of the first half, the rest of
    the costs the mean over it."""
    def f(lp, labels, xn, yn):
        h = lp.shape[0] // 2
        costs = call(lp[:h], labels[:h].contiguous(), xn[:h].contiguous(),
                     yn[:h].contiguous())
        return torch.cat([costs, costs.detach().mean().expand(
            lp.shape[0] - h)])
    return f


def _cost_altered(call):
    """One utterance's cost altered where it is produced (by 1%)."""
    def f(lp, labels, xn, yn):
        costs = call(lp, labels, xn, yn).detach().clone()
        costs[-1] *= 1.01
        return costs
    return f


def _grad_altered(call):
    """One lattice cell's gradient dropped where it is produced: the first
    cell of the last utterance, whose occupancy is 1."""
    def f(lp, labels, xn, yn):
        costs = call(lp, labels, xn, yn)
        with torch.no_grad():
            lp.grad[-1, 0, 0, :] = 0
        return costs
    return f


FAULTS = {"half_batch": _half_batch, "cost_altered": _cost_altered,
          "grad_altered": _grad_altered}


class Cell:
    def __init__(self, config, mix, seed, device, wrap=None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.wrap = wrap
        self.units = int(mix["N"])
        self.limits = mix["limits"]

    def setup(self):
        t0 = time.time()
        gen = traffic.generator(self.seed, self.device)
        self.lp = traffic.log_probs(self.mix, gen, self.device)
        self.lp.requires_grad_(True)
        self.pool = traffic.pool(self.mix, gen, self.device)
        self.valid = [counts.valid_cells(b["xn"].tolist(), b["yn"].tolist())
                      for b in self.pool]
        t1 = time.time()
        call = port_call(self.config)
        self.program = self.wrap(call) if self.wrap else call
        self.outputs = []
        for i in range(2):  # the kernels' build and load, the allocator
            self.call(i)
        self.lp.grad = None
        self.outputs = []
        self.phases = {"inputs": t1 - t0, "warm-up": time.time() - t1}

    def call(self, i):
        b = i % len(self.pool)
        batch = self.pool[b]
        self.lp.grad = None
        costs = self.program(self.lp, batch["labels"], batch["xn"],
                             batch["yn"])
        self.outputs.append((b, costs.detach()))

    def finish(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def context(self):
        used = [b for b, _ in self.outputs]
        return {"N": self.mix["N"], "T": self.mix["T"], "U": self.mix["U"],
                "V": self.mix["V"], "calls": len(used),
                "valid_cells": sum(self.valid[b] for b in used)}

    def check(self):
        lp = self.lp.detach()
        grad = self.lp.grad
        blank = int(self.config.get("blank", 0))
        worst, failed = 0.0, 0
        by_batch = {}
        for b, costs in self.outputs:
            by_batch.setdefault(b, []).append(costs)
        last = self.outputs[-1][0]
        grad_err = float("inf")
        for b, outs in by_batch.items():
            batch = self.pool[b]
            ref, gb, ge = lattice.loss(lp, batch["labels"], batch["xn"],
                                       batch["yn"], blank, torch.float64,
                                       grads=b == last)
            for costs in outs:
                err = ((costs.double() - ref).abs() / ref.abs()).max()
                err = float(err.nan_to_num(float("inf")))
                failed += err > self.limits["cost_rel_err"]
                worst = max(worst, err)
            if b == last:
                grad_err = (float("inf") if grad is None else
                            lattice.dense_grad_error(grad, batch["labels"],
                                                     gb, ge, blank))
                del gb, ge
        return ({"cost_rel_err": (worst, self.limits["cost_rel_err"]),
                 "grad_abs_err": (grad_err, self.limits["grad_abs_err"])},
                failed)
