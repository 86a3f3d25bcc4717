"""TensorFlow front end of the port (counterpart of
`warp_rnnt_tpu/bindings/tf_binding.py`).

The same `rnnt_loss` signature and options as the JAX package's TF front
end and the reference's (`tensorflow_binding/warp_rnnt_tf/__init__.py:80-131`),
a pure-TF `gather_log_probs`, and the TF faces of the fused and routed
joint losses.  Gradients of `transducer_loss` follow the reference
contract: computed during the forward op, the backward multiplies them by
the reshaped upstream (`__init__.py:134-148`).

One execution path, the DLPack bridge (``graph=False``): a
`tf.py_function` hands the TF tensors to the port through DLPack
(`tf.experimental.dlpack`, `torch.from_dlpack`), without a copy and on the
device they are on, runs the torch half (`bindings._bridge`), and hands
the results back the same way.  On a GPU the bridge reaches the port's
CUDA kernels: the forward gather, the lattice sweeps and the dense
gradient write (`ops.flat_kernels.flat_grad_write`; no host scatter); the
joint losses reach the fused joint kernels.  The device is synchronized as
the tensors cross, so TensorFlow's stream and torch's are ordered.  The
bridge works in eager mode and inside a plain `tf.function`.  Before TF
touches a GPU it shares with torch, turn on
`tf.config.experimental.set_memory_growth` for it, or TF reserves most of
the card's memory at start-up.

Not ported: the JAX package's graph path (``graph=True``,
`transducer_loss_graph`), which stages the JAX core into the TF graph with
`jax2tf`.  The port's counterpart would be a registered TF `OpKernel` on
TF's stream, built with TensorFlow's headers and flags beside the CUDA
toolkit; the port's kernels are built and checked on a GPU machine without
TensorFlow, so there is no such op.  So ``graph=True`` raises
`NotImplementedError` rather than taking the bridge quietly: the bridge is
a `py_function`, which neither ``tf.function(jit_compile=True)`` nor a
SavedModel can hold, and a quiet fallback would fail there, far from the
cause.  The arguments that pick a TPU serialization are dropped:
``platforms`` (`rnnt_loss`, `transducer_loss_graph`) and ``tpu``
(`rnnt_loss_fused_joint`, `rnnt_loss_joint`).

This module imports TensorFlow; `import warp_rnnt_tpu_torch` does not
import it.
"""

from __future__ import annotations

import functools

import tensorflow as tf
import torch

from warp_rnnt_tpu_torch.bindings import _bridge

NO_GRAPH_OP = (
    "warp_rnnt_tpu_torch has no graph-native TensorFlow op (that would be a"
    " registered TF OpKernel, built where TensorFlow with CUDA sits beside"
    " the CUDA toolkit).  Pass graph=False to take the DLPack bridge into"
    " the same kernels (eager and tf.function; not jit_compile=True or a"
    " SavedModel)."
)


def gather_log_probs(log_probs, labels, blank: int = 0):
    """(N, T, U, V) -> (N, T, U, 2) blank/label lattice, pure TF ops."""
    shape = tf.shape(log_probs)
    N, T = shape[0], shape[1]
    labels = tf.cast(labels, tf.int32)
    labels_ext = tf.concat([labels, tf.fill([N, 1], blank)], axis=1)  # (N, U)
    idx = tf.stack([tf.fill(tf.shape(labels_ext), blank), labels_ext], axis=-1)
    idx = tf.tile(idx[:, tf.newaxis, :, :], [1, T, 1, 1])  # (N, T, U, 2)
    return tf.gather(log_probs, idx, batch_dims=3, axis=3)


def _to_torch(x):
    return torch.from_dlpack(tf.experimental.dlpack.to_dlpack(x))


def _to_tf(x):
    return tf.experimental.dlpack.from_dlpack(
        torch.utils.dlpack.to_dlpack(x.contiguous()))


def _sync(x):
    """Wait for every stream of x's device, TF's included (a CUDA device
    only)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _crossing(fn, tensors, **kw):
    """Hand TF tensors to ``fn`` as torch tensors and its torch results back
    as TF tensors, the device synchronized on both crossings."""
    args = [_to_torch(x) for x in tensors]
    _sync(args[0])
    out = fn(*args, **kw)
    leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    _sync(leaves[0])
    return [_to_tf(x) for x in leaves]


def _ints(*xs):
    """Integer inputs cross as int64: TensorFlow keeps int32 tensors of a
    GPU op in host memory."""
    return [tf.cast(x, tf.int64) for x in xs]


def _compute(xs, ys, xn, yn, blank, fastemit_lambda):
    """The bridge's body: costs (N,) fp32 and the gradient of each cost."""
    return _crossing(_bridge.transducer_costs_and_grads, (xs, ys, xn, yn),
                     blank=blank, fastemit_lambda=fastemit_lambda)


def transducer_loss(log_probs, labels, frames_lengths, labels_lengths,
                    blank: int = 0, fastemit_lambda: float = 0.0):
    """Core op: per-sample costs with the reference gradient contract
    (upstream[n] times the gradients computed in the forward)."""
    ints = _ints(labels, frames_lengths, labels_lengths)
    compute = functools.partial(_compute, blank=blank,
                                fastemit_lambda=float(fastemit_lambda))

    @tf.custom_gradient
    def _op(xs):
        costs, grads = tf.py_function(compute, [xs, *ints],
                                      [tf.float32, xs.dtype])
        costs.set_shape(xs.shape[:1])
        grads.set_shape(xs.shape)

        def grad_fn(upstream):
            up = tf.cast(upstream, grads.dtype)
            return tf.reshape(up, [-1, 1, 1, 1]) * grads

        return costs, grad_fn

    return _op(tf.convert_to_tensor(log_probs))


def transducer_loss_graph(log_probs, labels, frames_lengths, labels_lengths,
                          blank: int = 0, fastemit_lambda: float = 0.0):
    """The JAX package's graph-native core op; not ported (see the module
    docstring).  Raises NotImplementedError."""
    raise NotImplementedError(NO_GRAPH_OP)


def _reduce(costs, frames_lengths, average_frames, reduction):
    if average_frames:
        costs = costs / tf.cast(frames_lengths, costs.dtype)
    if reduction in (None, "none"):
        return costs
    if reduction == "sum":
        return tf.reduce_sum(costs)
    if reduction == "mean":
        return tf.reduce_mean(costs)
    raise ValueError(
        f"Unknown reduction method: {reduction}, expected to be one of"
        " ['mean', 'sum', 'none']"
    )


def rnnt_loss(
    log_probs,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction=None,
    blank: int = 0,
    gather: bool = False,
    fastemit_lambda: float = 0.0,
    graph: bool = True,
):
    """The RNN-Transducer loss (TF front end, reference-parity signature).

    graph=False takes the DLPack bridge into the port (see the module
    docstring); with ``gather=True`` the lattice is gathered in TF first
    (`gather_log_probs`) and the bridge takes it pre-gathered
    (``blank=-1``).  graph=True, the JAX package's default, raises
    NotImplementedError: the port has no graph-native TF op.  The JAX
    package's ``platforms`` (a TPU serialization) is dropped.
    """
    assert average_frames is None or isinstance(average_frames, bool)
    assert reduction is None or reduction in ("none", "mean", "sum")
    assert isinstance(blank, int)
    assert isinstance(gather, bool)
    if graph:
        raise NotImplementedError(NO_GRAPH_OP)

    if gather and blank != -1:
        log_probs = gather_log_probs(log_probs, labels, blank)
        blank = -1
    costs = transducer_loss(
        log_probs, labels, frames_lengths, labels_lengths, blank,
        fastemit_lambda,
    )
    return _reduce(costs, frames_lengths, average_frames, reduction)


def _joint_loss(kind, f, g, params, labels, frames_lengths, labels_lengths,
                average_frames, reduction, blank, fastemit_lambda, mode):
    """Per-sample costs of the joint loss ``kind`` through the bridge, with
    a custom gradient to f, g and the four parameters, then the frames'
    average and the reduction in TF."""
    assert reduction is None or reduction in ("none", "mean", "sum")
    ints = _ints(labels, frames_lengths, labels_lengths)
    kw = dict(blank=blank, fastemit_lambda=float(fastemit_lambda), mode=mode)
    # A variable is read here, outside the custom gradient, so the tape
    # carries the gradient of the read tensor on to the variable.
    inputs = [tf.convert_to_tensor(x)
              for x in (f, g, *(params[k] for k in _bridge.JOINT_PARAMS))]

    def bridged(fn):
        return lambda *xs: _crossing(functools.partial(fn, kind), xs, **kw)

    @tf.custom_gradient
    def _op(*xs):
        (costs,) = tf.py_function(bridged(_bridge.joint_costs), [*xs, *ints],
                                  [tf.float32])
        costs.set_shape(xs[0].shape[:1])

        def grad_fn(upstream):
            grads = tf.py_function(bridged(_bridge.joint_grads),
                                   [*xs, *ints, upstream],
                                   [x.dtype for x in xs])
            for d, x in zip(grads, xs):
                d.set_shape(x.shape)
            return grads

        return costs, grad_fn

    costs = _op(*inputs)
    return _reduce(costs, frames_lengths, average_frames, reduction)


def rnnt_loss_fused_joint(
    f,
    g,
    params: dict,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction=None,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    mode: str = "add",
):
    """Fused joint-projection + RNN-T loss for TF users, through the bridge.

    f (N, T, F) encoder outputs, g (N, U, F') predictor outputs,
    ``params = dict(w_pre, b_pre, w_out, b_out)`` as TF tensors or
    variables.  The TF face of `warp_rnnt_tpu_torch.ops.fused_joint.
    rnnt_loss_fused_joint`: on a GPU the (N, T, U, V) logits never exist.
    Gradients flow to f, g and all four parameters.

    The parameter gradients sum upstream[n] times each cost's gradient
    over the samples, so the reference contract (gradients kept from the
    forward) does not carry over: the backward runs the forward again,
    with autograd, and takes its gradients under the upstream.  A
    loss+grad therefore costs one forward more than the torch call.  The
    JAX package's ``tpu`` argument (a TPU serialization) is dropped; no
    shape needs to be static.
    """
    return _joint_loss("fused", f, g, params, labels, frames_lengths,
                       labels_lengths, average_frames, reduction, blank,
                       fastemit_lambda, mode)


def rnnt_loss_joint(
    f,
    g,
    params: dict,
    labels,
    frames_lengths,
    labels_lengths,
    average_frames: bool = False,
    reduction=None,
    blank: int = 0,
    fastemit_lambda: float = 0.0,
    mode: str = "add",
):
    """Auto-routed joint network + RNN-T loss for TF users, through the
    bridge.

    The TF face of `warp_rnnt_tpu_torch.functional.joint_loss.
    rnnt_loss_joint` in its "auto" layout: `joint_layout_route` picks the
    fused kernels or the padded from-logits pipeline on the device the
    tensors are on.  Arguments, gradients and the backward's cost as
    `rnnt_loss_fused_joint`; the JAX package's ``tpu`` argument is
    dropped.
    """
    return _joint_loss("routed", f, g, params, labels, frames_lengths,
                       labels_lengths, average_frames, reduction, blank,
                       fastemit_lambda, mode)
