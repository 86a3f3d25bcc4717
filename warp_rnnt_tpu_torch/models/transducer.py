"""A complete (small) RNN-Transducer model and its training step
(counterpart of `warp_rnnt_tpu/models/transducer.py`).

  encoder:   dense "subsampling", then conv-GLU blocks over time, then a
             layernorm
  predictor: embedding and a unidirectional GRU over the labels
  joint:     `warp_rnnt_tpu_torch.models.joint.Joint`

The numerics follow the Flax modules' ``dtype`` semantics.  The dense and
conv layers compute in ``compute_dtype`` (bf16 by default): input, weight
and bias are cast to it, and the product and the bias sum are each rounded
to it.  The GLU runs in ``compute_dtype`` on the conv output and is then
cast to fp32.  The layernorms run in fp32 with Flax's epsilon 1e-6.  The
embedding and the GRU run in fp32.

Every module makes its parameters on ``device``: the card unless the
caller asks for another.  `Transducer.reset_parameters` draws them with
Flax's initializers: truncated lecun-normal weights and zero biases for the
dense and conv layers, layernorm scale 1 and bias 0, orthogonal recurrent
GRU kernels and a normal(0, 1/hidden) embedding.  `init_model` draws them
once, from its own generator; `carry_flax_transducer` carries a Flax
`Transducer` parameter tree across instead, and draws nothing.  Both build
the model on the "meta" device first, so no default initializer runs.

Flax's `GRUCell` has biases on the input kernels (ir, iz, in) and on hn
only.  Torch's GRU has a bias on every input and recurrent gate, and
computes the same function when the recurrent biases of r and z are zero.
So `Predictor` holds ``bias_hn`` alone and builds the recurrent bias
``[0, 0, bias_hn]`` at each call: the r and z thirds are constants, not
parameters, and the parameter count equals the Flax tree's.

The loss runs through the port's own entry points: `rnnt_loss_from_logits`
("from_logits", the default), `rnnt_loss(gather=True)` ("gather") and
`rnnt_loss_fused_joint` ("fused"), each on the kernels of `csrc/` when the
model is on the card.  The JAX module's shardings have no counterpart here.

`make_train_step` runs eagerly.  `compiled_train_step` is the port's
``jax.jit(make_train_step(...), donate_argnums=(0, 1))``: on the card the
whole step (loss, backward, optimizer update) is one CUDA graph a batch
shape (`utils.compiled_step`), the parameters and the optimizer's state
updated in place; it is not exported, as `compiled_step` is not.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from warp_rnnt_tpu_torch.functional.from_logits import rnnt_loss_from_logits
from warp_rnnt_tpu_torch.functional.loss import rnnt_loss
from warp_rnnt_tpu_torch.models.decoding import forget_decode_consts
from warp_rnnt_tpu_torch.models.joint import Joint, _dense, flax_leaf
from warp_rnnt_tpu_torch.ops.fused_joint import rnnt_loss_fused_joint

LN_EPS = 1e-6  # Flax nn.LayerNorm's epsilon
LOSS_MODES = ("from_logits", "gather", "fused")


def _linear(x, lin, cd):
    """Flax ``Dense(dtype=cd)`` on an ``nn.Linear``'s parameters."""
    return _dense(x.to(cd), lin.weight.t(), lin.bias, cd)


class ConvBlock(nn.Module):
    """Residual conv-GLU block; streamable (see `stream`).

    The convolution has no padding and `forward` pads ``kernel // 2``
    frames on each side explicitly: the same function as a "SAME" conv for
    an odd kernel at stride 1, and it lets `stream` run the same parameters
    over a cached context window.
    """

    def __init__(self, features: int, kernel: int = 5,
                 compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.features = features
        self.kernel = kernel
        self.compute_dtype = compute_dtype
        self.ln = nn.LayerNorm(features, eps=LN_EPS, device=device)
        self.conv = nn.Conv1d(features, 2 * features, kernel, device=device)

    def _conv_glu(self, h):
        """h (N, C + 2r, H) in ``compute_dtype`` -> GLU (N, C, H)."""
        cd = self.compute_dtype
        y = nn.functional.conv1d(h.transpose(1, 2), self.conv.weight.to(cd))
        y = y.transpose(1, 2) + self.conv.bias.to(cd)
        a, b = y.chunk(2, dim=-1)
        return a * torch.sigmoid(b)

    def forward(self, x):  # (N, T, H) fp32
        r = self.kernel // 2
        h = self.ln(x).to(self.compute_dtype)
        h = nn.functional.pad(h, (0, 0, r, r))
        return x + self._conv_glu(h).to(x.dtype)

    def stream_init(self, N):
        """Caches for chunked streaming: the last kernel-1 LN-space frames
        (zero: the full conv's left padding) and the last ``radius`` raw
        input frames still awaiting their right context."""
        r = self.kernel // 2
        dev = self.conv.weight.device
        return {
            "ln": torch.zeros((N, self.kernel - 1, self.features),
                              dtype=self.compute_dtype, device=dev),
            "x": torch.zeros((N, r, self.features), dtype=torch.float32,
                             device=dev),
        }

    def stream(self, carry, x_chunk, pos0, limit):
        """One streaming step over a chunk of C >= 1 input frames.

        ``pos0`` is the stream position of x_chunk[:, 0] in this block's
        input stream and ``limit`` its total length (a huge value while
        frames keep coming), ints or 0-d tensors.  Frames outside
        [0, limit) are zero in LN-space, as the full conv's padding is.
        Emits C output frames for positions pos0-radius .. pos0+C-radius-1;
        rows at positions outside the stream are junk the caller discards.
        """
        r = self.kernel // 2
        C = x_chunk.shape[1]
        ln = self.ln(x_chunk).to(self.compute_dtype)
        in_pos = pos0 + torch.arange(C, dtype=torch.int32, device=ln.device)
        ok = (in_pos >= 0) & (in_pos < limit)
        ln = torch.where(ok[None, :, None], ln, ln.new_zeros(()))
        full_ln = torch.cat([carry["ln"], ln], dim=1)      # (N, C+2r, H)
        glu = self._conv_glu(full_ln)                      # (N, C, H)
        x_all = torch.cat([carry["x"], x_chunk], dim=1)    # (N, C+r, H)
        y = x_all[:, :C] + glu.to(x_chunk.dtype)
        return {"ln": full_ln[:, -2 * r:], "x": x_all[:, -r:]}, y


class Encoder(nn.Module):
    """``inp`` dense (feat_dim -> hidden), conv blocks, ``out_ln``.  The
    JAX module reads feat_dim from its first input; this one takes it."""

    def __init__(self, hidden: int = 256, blocks: int = 2,
                 compute_dtype=torch.bfloat16, feat_dim: int = 80,
                 device="cuda"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.inp = nn.Linear(feat_dim, hidden, device=device)
        self.conv_blocks = nn.ModuleList(
            ConvBlock(hidden, compute_dtype=compute_dtype, device=device)
            for _ in range(blocks))
        self.out_ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def forward(self, feats):  # (N, T, F) -> (N, T, H) fp32
        h = _linear(feats, self.inp, self.compute_dtype).float()
        for blk in self.conv_blocks:
            h = blk(h)
        return self.out_ln(h)

    @property
    def lookahead(self):
        """Total algorithmic delay of `stream` in frames (sum of block
        radii): output frame t is emitted once input frame t+lookahead
        arrives."""
        return sum(b.kernel // 2 for b in self.conv_blocks)

    def stream_init(self, N):
        return {
            "m": torch.zeros((), dtype=torch.int32,
                             device=self.inp.weight.device),
            "blocks": tuple(b.stream_init(N) for b in self.conv_blocks),
        }

    def stream(self, carry, feats_chunk, limit):
        """Chunked encoding, equal to `forward` on the whole utterance.
        Feeding C raw frames emits C encoder frames for positions
        m-lookahead .. m+C-lookahead-1, returned as (carry, out, pos0) with
        pos0 the first one's position (rows outside [0, limit) are junk).
        ``limit`` is the final stream length, or a huge value while more
        frames are coming.  Any chunk size C >= 1 works."""
        h = _linear(feats_chunk, self.inp, self.compute_dtype).float()
        pos0 = carry["m"]
        new_blocks = []
        for blk, bc in zip(self.conv_blocks, carry["blocks"]):
            bc, h = blk.stream(bc, h, pos0, limit)
            new_blocks.append(bc)
            pos0 = pos0 - blk.kernel // 2
        new_carry = {"m": carry["m"] + feats_chunk.shape[1],
                     "blocks": tuple(new_blocks)}
        return new_carry, self.out_ln(h), pos0

    def stream_finish(self, carry, limit):
        """Flush the lookahead: push `lookahead` zero raw frames through
        (masked to padding in every block), emitting the final encoder
        frames up to position limit-1."""
        N = carry["blocks"][0]["ln"].shape[0]
        zeros = torch.zeros((N, self.lookahead, self.inp.in_features),
                            device=self.inp.weight.device)
        return self.stream(carry, zeros, limit)


class Predictor(nn.Module):
    """Embedding and a GRU over the labels, in fp32.  The GRU's gates are
    (r, z, n), as in torch and Flax; ``weight_ih`` (3H, H) holds the
    transposed Flax kernels ir, iz, in, ``weight_hh`` hr, hz, hn."""

    def __init__(self, vocab_size: int, hidden: int = 256, device="cuda"):
        super().__init__()
        self.hidden = hidden
        self.embed = nn.Embedding(vocab_size, hidden, device=device)
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, hidden,
                                                  device=device))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden,
                                                  device=device))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden, device=device))
        self.bias_hn = nn.Parameter(torch.zeros(hidden, device=device))

    def recurrent_bias(self):
        """torch's b_hh of the Flax GRU, whose recurrent bias is on hn
        only: (0, 0, bias_hn), (3H,)."""
        return torch.cat([self.bias_hn.new_zeros(2 * self.hidden),
                          self.bias_hn])

    def _gru_params(self):
        return [self.weight_ih, self.weight_hh, self.bias_ih,
                self.recurrent_bias()]

    def forward(self, labels):  # (N, U-1) int -> (N, U, H)
        """Row u of the output conditions on labels[:u]: the GRU runs over
        a zero vector (<sos>) and then the labels' embeddings."""
        emb = self.embed(labels.long())
        emb = nn.functional.pad(emb, (0, 0, 1, 0))
        h0 = self.initial_state(labels.shape[0])[None]
        with warnings.catch_warnings():
            # cuDNN copies the four tensors into one weight buffer a call
            # (6 H^2 + 4 H floats) and warns that it does so
            warnings.filterwarnings("ignore", "RNN module weights are not",
                                    UserWarning)
            out, _ = torch.gru(emb, h0, self._gru_params(), True, 1, 0.0,
                               self.training, False, True)
        return out

    def initial_state(self, N):
        return torch.zeros((N, self.hidden), device=self.embed.weight.device)

    def step(self, carry, token):
        """One decode step: (carry, token (N,) int; <0 = <sos>) -> (carry, g)."""
        token = token.long()
        emb = self.embed(token.clamp(min=0))
        emb = torch.where(token[:, None] < 0, emb.new_zeros(()), emb)
        h = torch.gru_cell(emb, carry, *self._gru_params())
        return h, h


class Transducer(nn.Module):
    """Encoder (two conv blocks), predictor and joint.  The JAX module's
    arguments, plus ``feat_dim`` (the JAX module reads it from its first
    input), the modules' ``compute_dtype`` (the JAX module's submodules
    take it; the default is theirs) and ``device``.  The parameters are
    drawn with Flax's initializers from the default generator
    (`reset_parameters`), except on the "meta" device, where they have no
    storage to fill."""

    def __init__(self, vocab_size: int, encoder_hidden: int = 256,
                 predictor_hidden: int = 256, joint_hidden: int = 512,
                 joint_mode: str = "add", feat_dim: int = 80,
                 compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.vocab_size = vocab_size
        self.joint_mode = joint_mode
        self.encoder = Encoder(encoder_hidden, compute_dtype=compute_dtype,
                               feat_dim=feat_dim, device=device)
        self.predictor = Predictor(vocab_size, predictor_hidden, device=device)
        joint_in = encoder_hidden + (predictor_hidden if joint_mode == "concat"
                                     else 0)
        self.joint = Joint(vocab_size, joint_in, joint_hidden, joint_mode,
                           device=device, compute_dtype=compute_dtype)
        self.reset_parameters()

    def forward(self, feats, labels, normalize: bool = True):
        """feats (N, T, F), labels (N, U-1) -> log-probs (N, T, U, V) fp32
        (raw logits when ``normalize=False``)."""
        return self.joint(self.encoder(feats), self.predictor(labels),
                          normalize)

    def encode(self, feats):
        return self.encoder(feats)

    def predictor_init(self, N):
        return self.predictor.initial_state(N)

    def predictor_step(self, carry, token):
        return self.predictor.step(carry, token)

    def joint_step(self, f_t, g_u):
        """f_t (N, H), g_u (N, H) -> log-probs (N, V) for one lattice cell."""
        return self.joint(f_t[:, None, :], g_u[:, None, :])[:, 0, 0, :]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """Flax's initializers, drawn on the CPU from ``generator`` (a CPU
        generator; the default one when None) and copied to the
        parameters' device, so one seed gives the same model on every
        device.  Does nothing to parameters on the "meta" device."""
        if self.joint.out.weight.is_meta:
            return
        gen = generator

        def lecun(p, fan_in):
            # jax.nn.initializers.lecun_normal: a normal truncated at two
            # standard deviations, scaled to variance 1 / fan_in
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std,
                                          -2 * std, 2 * std, generator=gen))

        enc = self.encoder
        for lin in (enc.inp, self.joint.pre, self.joint.out):
            lecun(lin.weight, lin.in_features)
            lin.bias.zero_()
        for blk in enc.conv_blocks:
            lecun(blk.conv.weight, blk.kernel * blk.features)
            blk.conv.bias.zero_()
        for ln in (*(b.ln for b in enc.conv_blocks), enc.out_ln):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        pred = self.predictor
        H = pred.hidden
        pred.embed.weight.copy_(torch.randn(pred.embed.weight.shape,
                                            generator=gen) / math.sqrt(H))
        lecun(pred.weight_ih, H)
        pred.weight_hh.copy_(torch.cat([
            nn.init.orthogonal_(torch.empty(H, H), generator=gen)
            for _ in range(3)]))
        pred.bias_ih.zero_()
        pred.bias_hn.zero_()


def transducer_loss_fn(model: Transducer, batch, fastemit_lambda=0.0,
                       loss_mode: str = "from_logits"):
    """Mean RNN-T loss of a batch ``(feats, labels, xn, yn)``.

    "from_logits" (the default) feeds the joint's raw logits to
    `rnnt_loss_from_logits`, which folds the log_softmax into the loss.
    "gather" normalizes, then calls `rnnt_loss(gather=True)`.  "fused"
    runs the joint's output projection inside the fused kernels
    (`rnnt_loss_fused_joint`): the (N, T, U, V) logits never exist.
    """
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode: {loss_mode!r}")
    feats, labels, xn, yn = batch
    if loss_mode == "fused":
        # the joint's own weights as (in, out) views, so that the fused
        # loss's gradient reaches the parameters the optimizer steps
        j = model.joint
        params = {"w_pre": j.pre.weight.t(), "b_pre": j.pre.bias,
                  "w_out": j.out.weight.t(), "b_out": j.out.bias}
        return rnnt_loss_fused_joint(
            model.encode(feats), model.predictor(labels), params, labels, xn,
            yn, reduction="mean", fastemit_lambda=fastemit_lambda,
            mode=model.joint_mode,
        )
    if loss_mode == "from_logits":
        return rnnt_loss_from_logits(
            model(feats, labels, normalize=False), labels, xn, yn,
            reduction="mean", fastemit_lambda=fastemit_lambda,
        )
    return rnnt_loss(model(feats, labels), labels, xn, yn, reduction="mean",
                     gather=True, fastemit_lambda=fastemit_lambda)


def make_train_step(model: Transducer, optimizer: torch.optim.Optimizer,
                    fastemit_lambda: float = 0.0,
                    loss_mode: str = "from_logits"):
    """Returns ``step(batch) -> loss``: zero the gradients, loss and
    backward, one optimizer step.  The loss comes back detached and on the
    model's device; nothing waits for the device."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode: {loss_mode!r}")

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = transducer_loss_fn(model, batch, fastemit_lambda, loss_mode)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_state(model: Transducer, optimizer: torch.optim.Optimizer):
    """The tensors a train step updates in place: the parameters, then
    every tensor of the optimizer's state (none before its first step)."""
    state = [p for p in model.parameters()]
    for per_param in optimizer.state.values():
        state += [v for v in per_param.values()
                  if isinstance(v, torch.Tensor)]
    return state


def compiled_train_step(model: Transducer, optimizer: torch.optim.Optimizer,
                        fastemit_lambda: float = 0.0,
                        loss_mode: str = "from_logits"):
    """`make_train_step` compiled once per shape: the port's
    ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``.

    Returns ``step(batch) -> loss``.  On a CUDA model the first call of a
    batch shape captures the whole step (the loss, its backward into the
    parameters and the optimizer's update) as one CUDA graph
    (`utils.compiled_step`, with the parameters and the optimizer's state
    as its ``state``, so the warm-up before the capture is undone and each
    call applies exactly one update); every call replays it.  The
    parameters and the optimizer's state are updated in place, as JAX's
    donated ``params`` and ``opt_state`` are, and the loss is the graph's
    static tensor, overwritten by the next call.  The optimizer must keep
    its step count on the device (``capturable=True``, as
    ``torch.optim.AdamW`` takes it); one that does not raises ValueError.
    A capture that fails raises: there is no eager fallback on the card.
    On the CPU the step runs eagerly, which is its plain version.  The
    graph is keyed by the model, its parameters' addresses, the optimizer,
    the loss mode, FastEmit's lambda and ``model.training``; whatever
    replaces a parameter or a state tensor (``load_state_dict``) needs
    ``step.compiled.release()``.  Each call drops the decoders' kept
    invariants of the model (`decoding.forget_decode_consts`), since a
    replay's update bumps no version counter.  ``step.compiled`` is the
    `CompiledStep` (its ``entry``: the graph, its static batch, capture ms
    and pool bytes)."""
    from warp_rnnt_tpu_torch.utils.compiled_step import compiled_step

    plain = make_train_step(model, optimizer, fastemit_lambda, loss_mode)
    if model.joint.out.weight.is_cuda and not all(
            g.get("capturable", False) for g in optimizer.param_groups):
        raise ValueError("compiled_train_step on the card needs an optimizer"
                         " built with capturable=True (its step count on the"
                         " device), which a CUDA graph can update")

    def key():
        return ("transducer.compiled_train_step", model, optimizer,
                tuple(p.data_ptr() for p in model.parameters()), loss_mode,
                float(fastemit_lambda), model.training)

    compiled = compiled_step(lambda *batch: (plain(batch),), key=key(),
                             state=lambda: train_state(model, optimizer))

    def step(batch):
        compiled.key = key()  # the addresses and the mode as they stand
        loss = compiled(*batch)[0]
        # a replay updates the weights without bumping their versions
        forget_decode_consts(model)
        return loss

    step.compiled = compiled
    return step


def init_model(generator_or_seed: Union[int, torch.Generator] = 0,
               vocab_size=32, feat_dim=80, N=4, T=32, U=8, device="cuda",
               **model_kwargs) -> Tuple[Transducer, Dict[str, torch.Tensor],
                                        Tuple]:
    """(model, params, example batch).  ``params`` is
    ``dict(model.named_parameters())``.  The parameters and the batch
    (feats normal (N, T, feat_dim), labels in [1, vocab) (N, U-1), xn = T,
    yn in [max(U // 2, 1), U), int32) are drawn on the CPU from one
    generator, so with one torch version a seed gives the same model and
    batch on every device."""
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    model = Transducer(vocab_size, feat_dim=feat_dim, device="meta",
                       **model_kwargs).to_empty(device=device)
    model.reset_parameters(gen)
    feats = torch.randn((N, T, feat_dim), generator=gen)
    labels = torch.randint(1, vocab_size, (N, U - 1), generator=gen,
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32)
    yn = torch.randint(max(U // 2, 1), U, (N,), generator=gen,
                       dtype=torch.int32)
    batch = tuple(x.to(device) for x in (feats, labels, xn, yn))
    return model, dict(model.named_parameters()), batch


def carry_flax_transducer(tree, joint_mode: str = "add", device="cuda",
                          compute_dtype=torch.bfloat16) -> Transducer:
    """A Flax `Transducer`'s parameters -> the port's `Transducer` computing
    the same function.

    tree: ``{"params": {"encoder": ..., "predictor": ..., "joint": ...}}``
    (or its ``"params"`` entry), leaves as numpy arrays, unboxed (the
    joint's ``out/kernel`` is a ``LogicallyPartitioned`` box in the Flax
    tree; `flax.linen.unbox` opens it).  A leaf of the wrong rank raises a
    ValueError naming its path.  Flax kernels are (in, out), a Conv kernel
    (k, in, out); torch's weights are (out, in) and (out, in, k).
    """
    p = tree.get("params", tree)
    enc = p["encoder"]
    n_blocks = sum(1 for k in enc if k.startswith("conv_blocks_"))
    inp = flax_leaf(p, ("encoder", "inp", "kernel"), 2)
    conv0 = flax_leaf(p, ("encoder", "conv_blocks_0", "conv", "kernel"), 3)
    emb = flax_leaf(p, ("predictor", "embed", "embedding"), 2)
    pre = flax_leaf(p, ("joint", "pre", "kernel"), 2)
    feat_dim, enc_hidden = inp.shape
    vocab_size, pred_hidden = emb.shape
    model = Transducer(vocab_size, enc_hidden, pred_hidden, pre.shape[1],
                       joint_mode, feat_dim, compute_dtype,
                       device="meta").to_empty(device=device)
    blocks = model.encoder.conv_blocks
    if (n_blocks, conv0.shape[0]) != (len(blocks), blocks[0].kernel):
        raise ValueError(
            f"{n_blocks} conv blocks of width {conv0.shape[0]}; the"
            f" Transducer has {len(blocks)} of width {blocks[0].kernel}")

    def put(param, path, value):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"leaf {path} of shape {value.shape} does not"
                             f" fit the model's {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    def leaf(path, rank, layout=None):
        value = flax_leaf(p, path, rank)
        return "/".join(path), value if layout is None else layout(value)

    def dense(lin, *path):
        put(lin.weight, *leaf((*path, "kernel"), 2, np.transpose))
        put(lin.bias, *leaf((*path, "bias"), 1))

    def norm(ln, *path):
        put(ln.weight, *leaf((*path, "scale"), 1))
        put(ln.bias, *leaf((*path, "bias"), 1))

    def gates(names, name, rank):
        parts = [leaf(("predictor", "cell", g, name), rank, np.transpose)[1]
                 for g in names]
        return f"predictor/cell/{{{','.join(names)}}}/{name}", np.concatenate(parts)

    e, pr = model.encoder, model.predictor
    with torch.no_grad():
        dense(e.inp, "encoder", "inp")
        for i, blk in enumerate(e.conv_blocks):
            path = ("encoder", f"conv_blocks_{i}")
            norm(blk.ln, *path, "ln")
            put(blk.conv.weight, *leaf((*path, "conv", "kernel"), 3,
                                       lambda k: k.transpose(2, 1, 0)))
            put(blk.conv.bias, *leaf((*path, "conv", "bias"), 1))
        norm(e.out_ln, "encoder", "out_ln")
        put(pr.embed.weight, "predictor/embed/embedding", emb)
        put(pr.weight_ih, *gates(("ir", "iz", "in"), "kernel", 2))
        put(pr.weight_hh, *gates(("hr", "hz", "hn"), "kernel", 2))
        put(pr.bias_ih, *gates(("ir", "iz", "in"), "bias", 1))
        put(pr.bias_hn, *leaf(("predictor", "cell", "hn", "bias"), 1))
        dense(model.joint.pre, "joint", "pre")
        dense(model.joint.out, "joint", "out")
    return model
