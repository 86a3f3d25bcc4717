"""The plain transducer: weights, forward, loss and AdamW, in plain PyTorch.

The model is a conv-GLU encoder (an input dense layer, conv blocks, a
final layernorm), a GRU predictor over <sos> and the labels, and a tanh
joint in add mode, with the numerics its configuration states: the dense
and conv products take bf16 inputs and round their outputs to bf16 (a
bias added in bf16), the GLU runs in bf16, the layernorms (epsilon 1e-6)
in fp32, the embedding and the GRU in fp32, the logits are widened to
fp32 and the log_softmax and the loss run in fp32 and float64.  The loss
is the mean over the batch of the RNN-T costs (`lattice.loss`), and each
step is one AdamW update (decoupled weight decay, bias-corrected
moments).

Weights live in a dict keyed by the names of the program's
`Transducer.named_parameters()`, so that the benchmark hands the same
tensors to both sides.  ``quant``, where given, rounds the inputs of every
bf16 product: the control passes a cast through float8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import lattice

LN_EPS = 1e-6


def shapes(cfg: dict) -> dict:
    """{name: (shape, fan_in or None)}: weights drawn normal / sqrt(fan_in),
    biases zero (None), layernorm scales one ("one")."""
    F_, H, J, V, K = (cfg[k] for k in ("feat_dim", "hidden", "joint",
                                       "vocab", "kernel"))
    out = {"encoder.inp.weight": ((H, F_), F_),
           "encoder.inp.bias": ((H,), None)}
    for i in range(cfg["blocks"]):
        p = f"encoder.conv_blocks.{i}."
        out.update({p + "ln.weight": ((H,), "one"), p + "ln.bias": ((H,), None),
                    p + "conv.weight": ((2 * H, H, K), H * K),
                    p + "conv.bias": ((2 * H,), None)})
    out.update({"encoder.out_ln.weight": ((H,), "one"),
                "encoder.out_ln.bias": ((H,), None),
                "predictor.embed.weight": ((V, H), H),
                "predictor.weight_ih": ((3 * H, H), H),
                "predictor.weight_hh": ((3 * H, H), H),
                "predictor.bias_ih": ((3 * H,), None),
                "predictor.bias_hn": ((H,), None),
                "joint.pre.weight": ((J, H), H), "joint.pre.bias": ((J,), None),
                "joint.out.weight": ((V, J), J), "joint.out.bias": ((V,), None)})
    return out


def init_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The weights, fp32 on ``device``, from one normal draw."""
    spec = shapes(cfg)
    drawn = [n for n, (_, fan) in spec.items() if isinstance(fan, int)]
    total = sum(math.prod(spec[n][0]) for n in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, fan) in spec.items():
        if fan is None:
            out[name] = torch.zeros(shape, device=device)
        elif fan == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) / math.sqrt(fan)
            at += n
    return out


def _q(x, quant):
    return x if quant is None else quant(x)


def _dense(x, w, b, cd, quant):
    """x @ w.T + b with bf16 inputs and outputs (w is (out, in))."""
    return (torch.matmul(_q(x.to(cd), quant), _q(w.to(cd), quant).t())
            + b.to(cd))


def encoder(w, feats, cfg, quant=None, cd=torch.bfloat16):
    H, K = cfg["hidden"], cfg["kernel"]
    h = _dense(feats, w["encoder.inp.weight"], w["encoder.inp.bias"], cd,
               quant).float()
    r = K // 2
    for i in range(cfg["blocks"]):
        p = f"encoder.conv_blocks.{i}."
        x = F.layer_norm(h, (H,), w[p + "ln.weight"], w[p + "ln.bias"], LN_EPS)
        x = F.pad(x.to(cd), (0, 0, r, r))
        y = F.conv1d(_q(x, quant).transpose(1, 2),
                     _q(w[p + "conv.weight"].to(cd), quant))
        y = y.transpose(1, 2) + w[p + "conv.bias"].to(cd)
        a, g = y.chunk(2, dim=-1)
        h = h + (a * torch.sigmoid(g)).float()
    return F.layer_norm(h, (H,), w["encoder.out_ln.weight"],
                        w["encoder.out_ln.bias"], LN_EPS)


def gru_cell(w, x, h, H):
    """One GRU step in fp32: gates (r, z, n), the recurrent bias on n."""
    gi = x @ w["predictor.weight_ih"].t() + w["predictor.bias_ih"]
    gh = h @ w["predictor.weight_hh"].t()
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * (gh[:, 2 * H:]
                                        + w["predictor.bias_hn"]))
    return (1 - z) * n + z * h


def predictor(w, labels, cfg):
    """(N, U-1) labels -> (N, U, H): the GRU's state after <sos> (a zero
    input) and after each label, from the zero state."""
    H = cfg["hidden"]
    x = F.pad(w["predictor.embed.weight"][labels.long()], (0, 0, 1, 0))
    h = torch.zeros(x.shape[0], H, device=x.device)
    outs = []
    for u in range(x.shape[1]):
        h = gru_cell(w, x[:, u], h, H)
        outs.append(h)
    return torch.stack(outs, dim=1)


def joint(w, f, g, quant=None, cd=torch.bfloat16):
    """Raw fp32 joint logits (N, T, U, V) of encoder frames f (N, T, H)
    and predictor rows g (N, U, H), added in bf16."""
    h = torch.tanh(_dense(f.to(cd)[:, :, None, :] + g.to(cd)[:, None, :, :],
                          w["joint.pre.weight"], w["joint.pre.bias"], cd,
                          quant))
    return _dense(h, w["joint.out.weight"], w["joint.out.bias"], cd,
                  quant).float()


def logits(w, feats, labels, cfg, quant=None):
    """Raw fp32 joint logits (N, T, U, V) of the training path."""
    return joint(w, encoder(w, feats, cfg, quant), predictor(w, labels, cfg),
                 quant)


def loss(w, batch, cfg, quant=None):
    """The mean over the batch of the RNN-T costs of the fp32 log-softmax."""
    feats, labels, xn, yn = batch
    lp = torch.log_softmax(logits(w, feats, labels, cfg, quant), dim=-1)
    return lattice.Loss.apply(lp, labels, xn, yn, torch.float64, 0).mean()


class Trainer:
    """AdamW on the plain model from weights ``w0`` (copied): ``step(batch)``
    takes one step and returns its loss; ``w`` holds the weights, ``m`` the
    first moments, ``v`` the second, ``t`` the steps taken and ``first``
    the first step's gradients.  ``moments`` (m, v) and ``t`` start it
    later than the first step."""

    def __init__(self, w0: dict, cfg: dict, quant=None, moments=None,
                 t: int = 0):
        self.cfg, self.quant, self.t = cfg, quant, t
        self.w = {k: v.detach().clone().requires_grad_(True)
                  for k, v in w0.items()}
        m, v = moments or ({}, {})
        self.m = {k: m[k].detach().clone() if k in m else torch.zeros_like(x)
                  for k, x in w0.items()}
        self.v = {k: v[k].detach().clone() if k in v else torch.zeros_like(x)
                  for k, x in w0.items()}
        self.first = None

    def step(self, batch) -> float:
        c = self.cfg
        lr, wd, eps = c["lr"], c["weight_decay"], c["eps"]
        b1, b2 = c["betas"]
        self.t += 1
        value = loss(self.w, batch, c, self.quant)
        grads = torch.autograd.grad(value, list(self.w.values()))
        with torch.no_grad():
            for (k, p), g in zip(self.w.items(), grads):
                p.mul_(1 - lr * wd)
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k] / (1 - b2 ** self.t)).sqrt_().add_(eps)
                p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
        if self.first is None:
            self.first = {k: g.detach() for k, g in zip(self.w, grads)}
        return float(value.detach())


def train(w0: dict, batches, cfg: dict, quant=None):
    """One AdamW step from ``w0`` on each of ``batches`` in turn: (losses,
    the first step's gradients, the weights after the last step)."""
    tr = Trainer(w0, cfg, quant)
    losses = [tr.step(b) for b in batches]
    return losses, tr.first, {k: p.detach() for k, p in tr.w.items()}


def fp8(x):
    """The control's rounding: through float8 (e4m3) and back."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)
