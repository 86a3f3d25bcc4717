"""The TensorFlow front end's checks, in one place: `chip_smoke.py` phase 18
runs them at the main path's full width on the card, and
`tests/test_torch_tf_binding.py` at small ones (on the card, and the
TensorFlow half on the CPU).  Each check raises an AssertionError on a
failure.

  * `check_bridge`: the bridge's torch half
    (`bindings._bridge.transducer_costs_and_grads`), which needs no
    TensorFlow, launching exactly its path's kernels, against the plain
    version on the same inputs (the plain gather, the scan, the plain dense
    write): costs rtol 1e-5, gradient within 5e-3 of its largest entry
    (the main path's tolerances, `chip_smoke.py` phase 4); and against the
    direct ``rnnt_loss(reduction="sum")`` loss+grad, bit for bit: both
    run the same kernels on the same values, and a cotangent of 1 scales
    nothing.
  * `check_tf_bridge` (TensorFlow present): `tf_binding.rnnt_loss(...,
    graph=False)` under a `GradientTape` on TF tensors made from the same
    values on the same device, against the direct ``rnnt_loss`` loss+grad,
    bit for bit; the bridge's results must come back on that device.
  * `check_tf_joint` (TensorFlow present): `tf_binding.
    rnnt_loss_fused_joint` (or `rnnt_loss_joint`) through TF against the
    direct calls, bit for bit: its costs against the no-grad call's, its
    six gradients under a per-sample upstream against the loss+grad's.
On a CUDA device each call runs with the launch counts set to 0 just
before and read just after (`serving_cases.launched`).
"""

from __future__ import annotations

import torch

import warp_rnnt_tpu_torch as wt
from warp_rnnt_tpu_torch.bindings import _bridge
from warp_rnnt_tpu_torch.benchmarks.serving_cases import launched
from warp_rnnt_tpu_torch.functional.core import rnnt_core_with_internals
from warp_rnnt_tpu_torch.functional.gather import gather_blank_label_plain
from warp_rnnt_tpu_torch.functional.loss import _labels_ext
from warp_rnnt_tpu_torch.ops.flat_kernels import flat_grad_write_plain

# The kernels the bridge's torch half launches: with a blank index (0 keys
# every blank >= 0), and pre-gathered (-1).
BRIDGE_KERNELS = {0: ("gather_lattice", "lattice_fused", "flat_write"),
                  -1: ("lattice_fused",)}
COST_RTOL, GRAD_TOL = 1e-5, 5e-3


def _counted(fn, device):
    """(fn(), {kernel: launches}); no counts off a CUDA device."""
    if device.type == "cuda":
        return launched(fn)
    return fn(), {}


def pregathered(xs, ys, blank=0):
    """The (N, T, U, 2) lattice of xs, by the plain gather."""
    return gather_blank_label_plain(xs, _labels_ext(ys, blank), blank)


def bridge_plain(xs, ys, xn, yn, blank=0):
    """The plain version of `transducer_costs_and_grads`: the plain gather,
    the scan, the plain dense write."""
    lat = xs if blank == -1 else pregathered(xs, ys, blank)
    costs, grads, _, _ = rnnt_core_with_internals(lat, xn, yn, 0.0, "scan")
    if blank == -1:
        return costs, grads
    N, T, U, V = xs.shape
    return costs, flat_grad_write_plain(
        grads[..., 0].contiguous(), grads[..., 1].contiguous(),
        _labels_ext(ys, blank), blank, V, U * V).view(N, T, U, V)


def direct_sum(xs, ys, xn, yn, blank=0):
    """The direct ``rnnt_loss(reduction="none")`` costs and the gradient of
    their sum (a cotangent of 1 a sample)."""
    x = xs.detach().requires_grad_()
    costs = wt.rnnt_loss(x, ys, xn, yn, blank=blank)
    costs.sum().backward()
    return costs.detach(), x.grad


def _unequal(a, b):
    return not (a.shape == b.shape and torch.equal(a, b))


def check_bridge(xs, ys, xn, yn, blank=0):
    """See the module docstring.  ``xs`` is (N, T, U, V) log-probs; with
    ``blank == -1`` it is gathered first (`pregathered`).  Returns
    ({"costs", "grad_share"}: the largest relative cost error and the
    gradient's largest error over its largest entry against the plain
    version, "direct": the largest absolute difference from the direct
    loss+grad (0.0); {kernel: launches})."""
    if blank == -1:
        xs = pregathered(xs, ys)
    tag = f"bridge blank={blank} at {tuple(xs.shape)}"
    (costs, grads), n = _counted(
        lambda: _bridge.transducer_costs_and_grads(xs, ys, xn, yn, blank),
        xs.device)
    if xs.is_cuda and set(n) != set(BRIDGE_KERNELS[min(blank, 0)]):
        raise AssertionError(f"{tag} launched {n}; its kernels are"
                             f" {BRIDGE_KERNELS[min(blank, 0)]}")
    if grads.shape != xs.shape or costs.shape != xn.shape:
        raise AssertionError(f"{tag}: costs {costs.shape}, grads {grads.shape}")
    for name, x in (("costs", costs), ("grads", grads)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{tag}: {name} not finite")
    costs_p, grads_p = bridge_plain(xs, ys, xn, yn, blank)
    errs = {"costs": float(((costs - costs_p).abs() / costs_p.abs()).max()),
            "grad_share": float((grads - grads_p).abs().max()
                                / grads_p.abs().max())}
    if errs["costs"] > COST_RTOL or errs["grad_share"] > GRAD_TOL:
        raise AssertionError(f"{tag} against the plain version: {errs}")
    del costs_p, grads_p
    costs_d, grads_d = direct_sum(xs, ys, xn, yn, blank)
    errs["direct"] = max(float((costs - costs_d).abs().max()),
                         float((grads - grads_d).abs().max()))
    if _unequal(costs, costs_d) or _unequal(grads, grads_d):
        raise AssertionError(f"{tag} against the direct loss+grad: max abs"
                             f" err {errs['direct']}")
    return errs, n


def tf_ints(tf, *xs):
    """Integer tensors as a TF user makes them: int32 constants, placed by
    TensorFlow."""
    return [tf.constant(x.cpu().numpy()) for x in xs]


def tf_loss_grad(tf, tfb, xs_tf, ys_tf, xn_tf, yn_tf, blank=0):
    """TF costs (reduction "none") and the gradient of their sum, through
    the bridge."""
    with tf.GradientTape() as tape:
        tape.watch(xs_tf)
        costs = tfb.rnnt_loss(xs_tf, ys_tf, xn_tf, yn_tf, blank=blank,
                              graph=False)
        total = tf.reduce_sum(costs)
    return costs, tape.gradient(total, xs_tf)


def _on_device(x_tf, device):
    """The TF tensor's device string names the torch device's type."""
    want = "GPU" if device.type == "cuda" else "CPU"
    return f"/device:{want}:" in x_tf.device


def check_tf_bridge(tf, tfb, xs, ys, xn, yn, blank=0):
    """See the module docstring; ``tfb`` is `bindings.tf_binding`.
    Returns ({"direct": max abs err (0.0)}, {kernel: launches})."""
    if blank == -1:
        xs = pregathered(xs, ys)
    tag = f"TF bridge blank={blank} at {tuple(xs.shape)}"
    args = [tfb._to_tf(xs), *tf_ints(tf, ys, xn, yn)]
    (costs, grad), n = _counted(
        lambda: tf_loss_grad(tf, tfb, *args, blank=blank), xs.device)
    if xs.is_cuda and set(n) != set(BRIDGE_KERNELS[min(blank, 0)]):
        raise AssertionError(f"{tag} launched {n}; its kernels are"
                             f" {BRIDGE_KERNELS[min(blank, 0)]}")
    if not (_on_device(costs, xs.device) and _on_device(grad, xs.device)):
        raise AssertionError(f"{tag}: results on {costs.device},"
                             f" {grad.device}, inputs on {xs.device}")
    costs, grad = tfb._to_torch(costs), tfb._to_torch(grad)
    costs_d, grads_d = direct_sum(xs, ys, xn, yn, blank)
    err = max(float((costs - costs_d).abs().max()),
              float((grad - grads_d).abs().max()))
    if _unequal(costs, costs_d) or _unequal(grad, grads_d):
        raise AssertionError(f"{tag} against the direct loss+grad: max abs"
                             f" err {err}")
    return {"direct": err}, n


def direct_joint(kind, f, g, weights, ys, xn, yn, upstream):
    """The direct torch calls of the joint loss ``kind``: the no-grad costs
    (the bridge's forward runs without autograd, which may take another
    lattice kernel), and the gradients to f, g and the weights under
    ``upstream``."""
    fn = _bridge.JOINT_LOSSES[kind]
    with torch.no_grad():
        costs = fn(f, g, dict(zip(_bridge.JOINT_PARAMS, weights)), ys, xn, yn)
    leaves = [x.detach().requires_grad_() for x in (f, g, *weights)]
    fn(leaves[0], leaves[1], dict(zip(_bridge.JOINT_PARAMS, leaves[2:])),
       ys, xn, yn).backward(upstream)
    return costs, [x.grad for x in leaves]


def check_tf_joint(tf, tfb, f, g, weights, ys, xn, yn, kind="fused"):
    """See the module docstring: the TF joint loss under a per-sample
    weighted sum, against `direct_joint`.  Returns ({"direct": max abs
    err (0.0)}, {kernel: launches})."""
    fn = {"fused": tfb.rnnt_loss_fused_joint, "routed": tfb.rnnt_loss_joint}
    upstream = torch.linspace(0.5, 1.5, f.shape[0], device=f.device)
    tag = f"TF joint {kind} at f {tuple(f.shape)}, w_out" \
          f" {tuple(weights[2].shape)}"
    xs_tf = [tfb._to_tf(x) for x in (f, g, *weights)]
    ints = tf_ints(tf, ys, xn, yn)
    up_tf = tfb._to_tf(upstream)

    def run():
        with tf.GradientTape() as tape:
            tape.watch(xs_tf)
            costs = fn[kind](xs_tf[0], xs_tf[1],
                             dict(zip(_bridge.JOINT_PARAMS, xs_tf[2:])), *ints)
            total = tf.reduce_sum(costs * up_tf)
        return costs, tape.gradient(total, xs_tf)

    (costs, grads), n = _counted(run, f.device)
    costs_d, grads_d = direct_joint(kind, f, g, weights, ys, xn, yn, upstream)
    got = [tfb._to_torch(x) for x in (costs, *grads)]
    want = [costs_d, *grads_d]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if any(_unequal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag} against the direct call: max abs err"
                             f" {err}")
    return {"direct": err}, n
