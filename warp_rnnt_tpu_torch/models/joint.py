"""Joint network for RNN-T training (counterpart of
`warp_rnnt_tpu/models/joint.py`).

Encoder frame vectors f (N, T, F) and predictor label vectors g (N, U, F')
are combined per lattice cell ("add": f + g; "concat": [f, g]), projected to
the joint width H, passed through tanh and projected to the vocabulary.
Both dense layers compute in ``compute_dtype``, as Flax's
``Dense(dtype=compute_dtype)`` does: inputs, kernel and bias are cast to it,
and the product's output and the bias sum are rounded to it.  bf16 is the
default, as in the JAX module; float32 is the full-precision joint that
`functional.joint_loss.rnnt_loss_joint` asks for with
``compute_dtype=torch.float32``.  The log_softmax runs in fp32.
`joint_logits` is the same computation on a ``params`` dict in the Flax
(in, out) layout, the form `rnnt_loss_joint` differentiates.

`carry_flax_joint` carries the weights of a Flax `Joint` across: its
``{"params": {"pre": {"kernel", "bias"}, "out": {...}}}`` tree, as numpy
arrays, becomes the state of this module, and the same tree gives the
``params`` dict of `rnnt_loss_fused_joint`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _dense(x, w, b, cd):
    """x @ w + b in ``cd``; w is (in, out)."""
    return torch.matmul(x, w.to(cd)) + b.to(cd)


def joint_hidden(f, g, w_pre, b_pre, mode: str = "add",
                 compute_dtype=torch.bfloat16):
    """The joint's hidden layer tanh(combine(f, g) @ w_pre + b_pre) in
    ``compute_dtype``: f (N, T, F), g (N, U, F') -> (N, T, U, H), or 2-D
    rows (STU, F), (STU, F') -> (STU, H)."""
    if mode not in ("add", "concat"):
        raise ValueError(f"unknown joint mode: {mode!r}")
    cd = compute_dtype
    f = f.to(cd)
    g = g.to(cd)
    if f.dim() == 2:
        h = f + g if mode == "add" else torch.cat([f, g], dim=-1)
    elif mode == "add":
        h = f[:, :, None, :] + g[:, None, :, :]
    else:
        N, T, _ = f.shape
        U = g.shape[1]
        h = torch.cat([f[:, :, None, :].expand(N, T, U, f.shape[-1]),
                       g[:, None, :, :].expand(N, T, U, g.shape[-1])], dim=-1)
    return torch.tanh(_dense(h, w_pre, b_pre, cd))


def joint_logits(f, g, params, mode: str = "add",
                 compute_dtype=torch.bfloat16, normalize: bool = True):
    """The Tanh-MLP joint on ``params = dict(w_pre, b_pre, w_out, b_out)``
    (Flax layout, kernels (in, out)): f (N, T, F), g (N, U, F') ->
    log-probs (N, T, U, V) fp32, or raw fp32 logits when
    ``normalize=False``.  Packed mode: 2-D rows f (STU, F), g (STU, F'),
    one per lattice cell, give (STU, V)."""
    cd = compute_dtype
    h = joint_hidden(f, g, params["w_pre"], params["b_pre"], mode, cd)
    logits = _dense(h, params["w_out"], params["b_out"], cd).float()
    return torch.log_softmax(logits, dim=-1) if normalize else logits


class Joint(nn.Module):
    """Tanh-MLP joint: combine -> dense(H) -> tanh -> dense(V) -> log_softmax.

    ``in_features`` is F for "add" (both halves F wide) and F + F' for
    "concat".  The weights are ``nn.Linear``'s (out, in), made on ``device``
    (the card unless the caller asks for another); a Flax kernel is
    (in, out), so `carry_flax_joint` transposes it.  ``compute_dtype`` is
    the dense layers' dtype (bf16, or torch.float32).
    """

    def __init__(self, vocab_size: int, in_features: int, hidden: int = 512,
                 mode: str = "add", device="cuda", compute_dtype=torch.bfloat16):
        super().__init__()
        if mode not in ("add", "concat"):
            raise ValueError(f"unknown joint mode: {mode!r}")
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.pre = nn.Linear(in_features, hidden, device=device)
        self.out = nn.Linear(hidden, vocab_size, device=device)

    def forward(self, f, g, normalize: bool = True):
        """f (N, T, F), g (N, U, F') -> log-probs (N, T, U, V) fp32 (raw
        fp32 logits when ``normalize=False``); 2-D rows give (STU, V)."""
        params = {"w_pre": self.pre.weight.t(), "b_pre": self.pre.bias,
                  "w_out": self.out.weight.t(), "b_out": self.out.bias}
        return joint_logits(f, g, params, self.mode, self.compute_dtype,
                            normalize)


def flax_leaf(tree, path, rank):
    """The leaf of a Flax parameter tree at ``path`` as a float32 numpy
    array, or a ValueError naming the path when it is not an array of
    ``rank`` dimensions (a boxed leaf, such as ``LogicallyPartitioned``,
    reads as a 0-d object array: pass ``flax.linen.unbox(params)``)."""
    node = tree
    for key in path:
        node = node[key]
    arr = np.asarray(node)
    if arr.dtype == object or arr.ndim != rank:
        raise ValueError(
            f"leaf {'/'.join(path)} must be a rank-{rank} array, got"
            f" {type(node).__name__} of shape {arr.shape}"
            " (unbox the tree with flax.linen.unbox)")
    return arr.astype(np.float32)


def carry_flax_joint(tree, mode: str = "add", device="cuda"):
    """A Flax `Joint`'s parameters -> (Joint module, fused-loss params).

    tree: ``{"params": {"pre": {"kernel", "bias"}, "out": {...}}}`` (or its
    ``"params"`` entry), leaves as numpy arrays, unboxed (a leaf of the
    wrong rank raises a ValueError naming its path).  Returns the port's `Joint`
    holding those weights (fp32, on ``device``) and the dict ``w_pre, b_pre,
    w_out, b_out`` that `rnnt_loss_fused_joint` takes, as new fp32 leaf
    tensors on ``device`` in the Flax (in, out) layout.
    """
    p = tree.get("params", tree)
    arrays = {(layer, name): flax_leaf(p, (layer, name), rank)
              for layer in ("pre", "out")
              for name, rank in (("kernel", 2), ("bias", 1))}
    in_features, hidden = arrays["pre", "kernel"].shape
    vocab_size = arrays["out", "kernel"].shape[1]
    joint = Joint(vocab_size, in_features, hidden, mode=mode, device=device)
    with torch.no_grad():
        for layer in ("pre", "out"):
            lin = getattr(joint, layer)
            lin.weight.copy_(torch.tensor(arrays[layer, "kernel"].T))
            lin.bias.copy_(torch.tensor(arrays[layer, "bias"]))
    params = {key: torch.tensor(arrays[layer, name], device=device)
              for key, layer, name in (("w_pre", "pre", "kernel"),
                                       ("b_pre", "pre", "bias"),
                                       ("w_out", "out", "kernel"),
                                       ("b_out", "out", "bias"))}
    return joint, params
