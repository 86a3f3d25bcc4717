"""Parity of the PyTorch port's transducer model and train step
(`warp_rnnt_tpu_torch/models/transducer.py`) with the JAX package's, on the
CPU.

One Flax parameter tree, unboxed and as numpy arrays, goes into the JAX
module and, through `carry_flax_transducer`, into the port.  Two variants:
  * "bf16", the default model (the dense, conv and joint layers in bf16):
    the frameworks round to bf16 at the same places but sum in another
    order, so a rounding flips now and then.  Outputs agree within 4 bf16
    ulps of their largest entry (`_bf16_ulp`); losses and gradients with
    the tolerance of `tests/test_fused_joint.py:201-205` (loss rtol 2e-3,
    each gradient within rtol 0.1 and atol 3e-2 of its largest entry:
    `train_cases.compare_grads`).
  * "fp32": a test-side JAX subclass of `Transducer` whose encoder and
    joint compute in fp32 (`_Fp32Transducer`; no JAX file changes), and the
    port's ``compute_dtype=torch.float32``.  Outputs rtol 1e-5 (atol 1e-5 of
    the largest entry); losses rtol 1e-5 and gradients within 1e-5 of their
    largest entry and rtol 1e-5, except "fused", whose joint is bf16 in both
    packages and takes the bf16 tolerance.
The checks: `ConvBlock`, `Encoder`, `Predictor` (sequence and `step`, with
<sos> tokens), `Transducer.forward` (normalized and not), `joint_step` and
`predictor_step`; the encoder's chunked stream against the whole-utterance
encoder at every chunking (bf16 exact, as `tests/test_streaming.py:56-82`
holds JAX; fp32 within 1e-6: torch's fp32 conv and matmul on the CPU give
other bits by input length, observed 4.8e-7) and against JAX's stream;
`transducer_loss_fn` in the three loss modes, with FastEmit too; the AdamW
parameters after 1 and 3 `make_train_step` steps against `optax.adamw(1e-3)`
(fp32, within 1e-5, 1 % of a step); the loss falling over 5 steps (as
`tests/test_models_and_parallel.py:113`); the parameter count, with no r/z
recurrent GRU bias; `init_model`'s shapes, device and initializer
statistics, and that neither it nor the carry draws from torch's default
generator; the boxed-leaf errors.  The train step's `cuda` tests are in
`tests/test_torch_train_card.py`: the card has no flax or optax, which
this file imports.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import warp_rnnt_tpu_torch.models as tm
from warp_rnnt_tpu.models import transducer as jt
from warp_rnnt_tpu.models.joint import Joint as FlaxJoint
from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
from warp_rnnt_tpu_torch.models import (
    carry_flax_joint,
    carry_flax_transducer,
    init_model,
    make_train_step,
    transducer_loss_fn,
)

MODES = ("from_logits", "gather", "fused")
VARIANTS = ("bf16", "fp32")
N, T, U, F, V, HE, HP, HJ = 3, 12, 5, 10, 17, 24, 24, 32
FP32_RTOL = 1e-5


class _Fp32Transducer(jt.Transducer):
    """The JAX Transducer with its encoder and joint in fp32 (same tree)."""

    def setup(self):
        self.encoder = jt.Encoder(self.encoder_hidden, compute_dtype=jnp.float32)
        self.predictor = jt.Predictor(self.vocab_size, self.predictor_hidden)
        self.joint = FlaxJoint(self.vocab_size, self.joint_hidden,
                               self.joint_mode, compute_dtype=jnp.float32)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, F).astype(np.float32)
    labels = rng.randint(1, V, (N, U - 1)).astype(np.int32)
    xn = np.array([T, 9, 5], np.int32)
    yn = np.array([U - 1, 2, 1], np.int32)
    return feats, labels, xn, yn


@pytest.fixture(scope="module", params=VARIANTS)
def setup(request):
    """(variant, JAX model, unboxed params, port model, numpy batch)."""
    variant = request.param
    cls = _Fp32Transducer if variant == "fp32" else jt.Transducer
    model = cls(vocab_size=V, encoder_hidden=HE, predictor_hidden=HP,
                joint_hidden=HJ)
    feats, labels, xn, yn = _inputs()
    params = nn.unbox(model.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                                 jnp.asarray(labels)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cd = torch.float32 if variant == "fp32" else torch.bfloat16
    port = carry_flax_transducer(tree, device="cpu", compute_dtype=cd)
    return variant, model, params, port, (feats, labels, xn, yn)


def _bf16_ulp(x):
    x = max(float(np.abs(x).max()), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _assert_out(variant, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if variant == "fp32":
        np.testing.assert_allclose(got, want, rtol=FP32_RTOL,
                                   atol=FP32_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * _bf16_ulp(want))


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def test_parameter_count_equals_the_flax_tree(setup):
    _, _, params, port, _ = setup
    names = dict(port.named_parameters())
    assert sum(p.numel() for p in names.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    # the GRU's 6 kernels and 4 biases are 4 tensors here (weight_ih,
    # weight_hh, bias_ih, bias_hn); the r/z recurrent biases are none
    assert len(names) == len(jax.tree_util.tree_leaves(params)) - 6
    assert tuple(names["predictor.bias_hn"].shape) == (HP,)
    assert not any("bias_hh" in k for k in names)


def test_conv_block_matches_flax(setup):
    variant, model, params, port, _ = setup
    x = np.random.RandomState(3).randn(N, T, HE).astype(np.float32)
    want = model.bind(params).encoder.conv_blocks[0](jnp.asarray(x))
    with torch.no_grad():
        got = port.encoder.conv_blocks[0](torch.tensor(x))
    _assert_out(variant, got, want)


def test_encoder_matches_flax(setup):
    variant, model, params, port, (feats, *_) = setup
    want = model.apply(params, jnp.asarray(feats), method=jt.Transducer.encode)
    with torch.no_grad():
        got = port.encode(torch.tensor(feats))
    _assert_out(variant, got, want)


def test_predictor_matches_flax(setup):
    variant, model, params, port, (_, labels, _, _) = setup
    want = model.apply(params, jnp.asarray(labels),
                       method=lambda m, lbl: m.predictor(lbl))
    with torch.no_grad():
        got = port.predictor(torch.tensor(labels))
    _assert_out(variant, got, want)


def test_predictor_steps_match_flax(setup):
    """Four decode steps from the initial state; token -1 (<sos>) embeds to
    zero."""
    variant, model, params, port, _ = setup
    tokens = np.array([[-1, 3, 0], [5, -1, 16], [1, 2, -1], [0, 7, 7]],
                      np.int32)
    bound = model.bind(params)
    jc = bound.predictor_init(N)
    with torch.no_grad():
        pc = port.predictor_init(N)
        for tok in tokens:
            jc, jg = bound.predictor_step(jc, jnp.asarray(tok))
            pc, pg = port.predictor_step(pc, torch.tensor(tok))
            _assert_out(variant, pg, jg)
            _assert_out(variant, pc, jc)


@pytest.mark.parametrize("normalize", [True, False])
def test_transducer_forward_matches_flax(setup, normalize):
    variant, model, params, port, (feats, labels, _, _) = setup
    want = model.apply(params, jnp.asarray(feats), jnp.asarray(labels),
                       normalize=normalize)
    with torch.no_grad():
        got = port(*_t(feats, labels), normalize=normalize)
    assert got.dtype == torch.float32
    _assert_out(variant, got, want)


def test_joint_step_matches_flax(setup):
    variant, model, params, port, _ = setup
    rng = np.random.RandomState(4)
    f_t = rng.randn(N, HE).astype(np.float32)
    g_u = rng.randn(N, HP).astype(np.float32)
    want = model.apply(params, jnp.asarray(f_t), jnp.asarray(g_u),
                       method=jt.Transducer.joint_step)
    with torch.no_grad():
        got = port.joint_step(*_t(f_t, g_u))
    assert tuple(got.shape) == (N, V)
    _assert_out(variant, got, want)


def _stream(encoder, feats, C, limit_big, finish_limit, put):
    """Feed ``feats`` in chunks of C, then flush; ``put(out, pos0)``."""
    st = encoder.stream_init(feats.shape[0])
    i, Tn = 0, feats.shape[1]
    while i < Tn:
        st, out, p0 = encoder.stream(st, feats[:, i:i + C], limit_big)
        put(out, p0)
        i += min(C, Tn - i)
    st, out, p0 = encoder.stream_finish(st, finish_limit)
    put(out, p0)


def _collect(full_shape):
    got = np.full(full_shape, np.nan, np.float32)
    seen = []

    def put(out, p0):
        o = np.asarray(out.detach() if isinstance(out, torch.Tensor) else out)
        seen.append((int(p0), o))
        for j in range(o.shape[1]):
            if 0 <= int(p0) + j < full_shape[1]:
                got[:, int(p0) + j] = o[:, j]

    return got, seen, put


STREAM_T = 41


@pytest.mark.parametrize("C", [1, 2, 5, 13, STREAM_T])
def test_encoder_stream_equals_encode(setup, C):
    """Every chunking gives the whole-utterance encoder: exactly in bf16 (the
    contract of `tests/test_streaming.py:56-82`); within 1e-6 in fp32."""
    variant, _, _, port, _ = setup
    feats = torch.tensor(np.random.RandomState(5).randn(2, STREAM_T, F)
                         .astype(np.float32))
    with torch.no_grad():
        full = port.encode(feats).numpy()
        got, _, put = _collect(full.shape)
        _stream(port.encoder, feats, C, 2 ** 30, STREAM_T, put)
    atol = 1e-6 if variant == "fp32" else 0.0
    np.testing.assert_allclose(got, full, rtol=0, atol=atol)


def test_encoder_stream_matches_flax_stream(setup):
    """The port's stream emits JAX's chunks at JAX's positions (C=5, with
    the flush), junk rows included."""
    variant, model, params, port, _ = setup
    x = np.random.RandomState(6).randn(2, STREAM_T, F).astype(np.float32)
    bound = model.bind(params)
    _, want, jput = _collect((2, STREAM_T, HE))
    _stream(bound.encoder, jnp.asarray(x), 5, jnp.asarray(2 ** 30, jnp.int32),
            jnp.asarray(STREAM_T, jnp.int32), jput)
    _, got, pput = _collect((2, STREAM_T, HE))
    with torch.no_grad():
        _stream(port.encoder, torch.tensor(x), 5, 2 ** 30, STREAM_T, pput)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_out(variant, g, w)
    assert port.encoder.lookahead == bound.encoder.lookahead == 4


def _jax_loss_and_grads(model, params, batch, mode, fastemit=0.0):
    jb = tuple(jnp.asarray(x) for x in batch)
    loss, grads = jax.value_and_grad(
        lambda p: jt.transducer_loss_fn(model, p, jb, fastemit, mode))(params)
    # the gradient tree carried as a model: its parameters are JAX's
    # gradients in the port's names and layouts
    gmodel = carry_flax_transducer(jax.tree_util.tree_map(np.asarray, grads),
                                   device="cpu")
    return float(loss), {k: p.detach() for k, p in gmodel.named_parameters()}


def _assert_loss_and_grads(variant, mode, ref, got):
    if variant == "bf16" or mode == "fused":
        assert tc.compare_grads(ref, got, mode) <= 1.0
        return
    (l_ref, g_ref), (l_got, g_got) = ref, got
    np.testing.assert_allclose(float(l_got), l_ref, rtol=FP32_RTOL)
    for name, r in g_ref.items():
        r = r.numpy()
        np.testing.assert_allclose(g_got[name].numpy(), r, rtol=FP32_RTOL,
                                   atol=FP32_RTOL * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax(setup, mode):
    variant, model, params, port, batch = setup
    ref = _jax_loss_and_grads(model, params, batch, mode)
    got = tc.loss_and_grads(port, _t(*batch), mode)
    _assert_loss_and_grads(variant, mode, ref, got)


@pytest.mark.parametrize("setup", ["fp32"], indirect=True)
@pytest.mark.parametrize("mode", MODES)
def test_fastemit_loss_and_grads_match_jax(setup, mode):
    """FastEmit (lambda 0.01), on the fp32 variant."""
    variant, model, params, port, batch = setup
    ref = _jax_loss_and_grads(model, params, batch, mode, fastemit=0.01)
    port.zero_grad(set_to_none=True)
    loss = transducer_loss_fn(port, _t(*batch), 0.01, mode)
    loss.backward()
    got = loss.detach(), {k: p.grad for k, p in port.named_parameters()}
    _assert_loss_and_grads(variant, mode, ref, got)


@pytest.mark.parametrize("mode", ["from_logits", "gather"])
def test_adamw_steps_match_optax(mode):
    """The fp32 variant's parameters after 1 and 3 steps of
    `make_train_step` with AdamW(1e-3, weight_decay=1e-4) against
    `optax.adamw(1e-3)`, within 1e-5: 1 % of one Adam step (lr = 1e-3).
    Adam's first step is lr g / (|g| + eps), which scales a gradient's
    absolute error by up to lr / (4 eps) where |g| is near eps = 1e-8, so
    the few gradients of that size set the tolerance (the largest
    deviation seen: 1.26e-6, one entry of 1728 in weight_hh)."""
    model = _Fp32Transducer(vocab_size=V, encoder_hidden=HE,
                            predictor_hidden=HP, joint_hidden=HJ)
    batch = _inputs(7)
    jb = tuple(jnp.asarray(x) for x in batch)
    params = nn.unbox(model.init(jax.random.PRNGKey(2), jb[0], jb[1]))
    port = carry_flax_transducer(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu", compute_dtype=torch.float32)
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    jstep = jax.jit(jt.make_train_step(model, opt, loss_mode=mode))
    pstep = make_train_step(port, torch.optim.AdamW(
        port.parameters(), lr=1e-3, weight_decay=1e-4), loss_mode=mode)
    tb = _t(*batch)
    for k in range(1, 4):
        params, state, jloss = jstep(params, state, jb)
        ploss = pstep(tb)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=FP32_RTOL)
        if k in (1, 3):
            want = carry_flax_transducer(
                jax.tree_util.tree_map(np.asarray, params), device="cpu")
            for name, w in want.named_parameters():
                np.testing.assert_allclose(
                    dict(port.named_parameters())[name].detach().numpy(),
                    w.detach().numpy(), rtol=0, atol=1e-5,
                    err_msg=f"{name} after {k} steps")


@pytest.mark.parametrize("mode", MODES)
def test_loss_falls_over_five_steps(mode):
    """`tests/test_models_and_parallel.py:113` on the port: log-probs
    normalize over V, and five steps on a fixed batch lower the loss."""
    model, params, batch = init_model(
        0, vocab_size=16, feat_dim=20, N=4, T=12, U=4, device="cpu",
        encoder_hidden=32, predictor_hidden=32, joint_hidden=32)
    feats, labels, xn, yn = batch
    with torch.no_grad():
        lp = model(feats, labels)
    assert tuple(lp.shape) == (4, 12, 4, 16)
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), np.ones((4, 12, 4)),
                               rtol=1e-3)
    step = make_train_step(model, torch.optim.AdamW(
        params.values(), lr=1e-3, weight_decay=1e-4), loss_mode=mode)
    losses = [float(step(batch)) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_init_model_shapes_and_device(setup):
    """The Flax tree's shapes (as carried into the port), the batch's dtypes
    and ranges, the CPU device, and one seed giving one model."""
    want = setup[3]
    model, params, (feats, labels, xn, yn) = init_model(
        0, vocab_size=V, feat_dim=F, N=4, T=12, U=6, device="cpu",
        encoder_hidden=HE, predictor_hidden=HP, joint_hidden=HJ)
    assert params == dict(model.named_parameters())
    assert {k: tuple(p.shape) for k, p in params.items()} == {
        k: tuple(p.shape) for k, p in want.named_parameters()}
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in params.values())
    assert feats.shape == (4, 12, F) and feats.dtype == torch.float32
    assert labels.shape == (4, 5) and labels.dtype == torch.int32
    assert int(labels.min()) >= 1 and int(labels.max()) < V
    assert (xn == 12).all() and xn.dtype == yn.dtype == torch.int32
    assert int(yn.min()) >= 3 and int(yn.max()) < 6
    again = init_model(torch.Generator().manual_seed(0), vocab_size=V,
                       feat_dim=F, N=4, T=12, U=6, device="cpu",
                       encoder_hidden=HE, predictor_hidden=HP,
                       joint_hidden=HJ)
    for k, p in again[1].items():
        assert torch.equal(p, params[k]), k
    assert torch.equal(again[2][0], feats)


def test_init_model_follows_flax_initializers():
    """Truncated lecun-normal kernels (std sqrt(1/fan_in), cut at two of
    the normal's deviations), zero biases, layernorms 1 and 0, orthogonal
    recurrent GRU blocks, a normal(0, 1/H) embedding; statistics within 5 %
    at H=256."""
    H, Vb, Fb = 256, 512, 80
    model, params, _ = init_model(1, vocab_size=Vb, feat_dim=Fb, N=1, T=2,
                                  U=2, device="cpu", encoder_hidden=H,
                                  predictor_hidden=H, joint_hidden=H)
    fans = {"encoder.inp.weight": Fb, "encoder.conv_blocks.0.conv.weight": 5 * H,
            "joint.pre.weight": H, "joint.out.weight": H,
            "predictor.weight_ih": H}
    for name, fan_in in fans.items():
        w = params[name].detach()
        std = fan_in ** -0.5
        assert abs(w.std().item() / std - 1) < 0.05, name
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    for name, p in params.items():
        if ".ln." in name or "out_ln" in name:
            assert (p == (1.0 if name.endswith("weight") else 0.0)).all(), name
        elif "bias" in name:
            assert (p == 0.0).all(), name
    whh = params["predictor.weight_hh"].detach().double()
    for g in range(3):
        q = whh[g * H:(g + 1) * H]
        torch.testing.assert_close(q @ q.T, torch.eye(H, dtype=torch.float64),
                                   rtol=0, atol=1e-5)
    emb = params["predictor.embed.weight"].detach()
    assert abs(emb.std().item() * H ** 0.5 - 1) < 0.05


def test_init_and_carry_leave_the_default_generator_alone():
    """`init_model` draws from its own generator only, and
    `carry_flax_transducer` draws nothing: both build on the "meta" device,
    so no default initializer runs."""
    torch.manual_seed(5)
    state = torch.get_rng_state()
    init_model(0, vocab_size=V, feat_dim=F, N=2, T=6, U=3, device="cpu",
               encoder_hidden=HE, predictor_hidden=HP, joint_hidden=HJ)
    carry_flax_transducer(tc.flax_tree(0, V, F, HE), device="cpu")
    assert torch.equal(torch.get_rng_state(), state)


def test_carry_rejects_a_boxed_leaf(setup):
    """A tree that was not unboxed: the joint's out/kernel is a
    `LogicallyPartitioned` box (as `Joint` makes it), which numpy reads as
    a 0-d object array; both carries name the leaf."""
    params = setup[2]["params"]
    out = params["joint"]["out"]
    joint = {"pre": params["joint"]["pre"],
             "out": {"bias": out["bias"], "kernel": nn.LogicallyPartitioned(
                 out["kernel"], ("joint_hidden", "vocab"))}}
    boxed = {"params": {**params, "joint": joint}}
    with pytest.raises(ValueError, match="joint/out/kernel"):
        carry_flax_transducer(boxed, device="cpu")
    with pytest.raises(ValueError, match="out/kernel"):
        carry_flax_joint({"params": joint}, device="cpu")
    ok = carry_flax_transducer(nn.unbox(boxed), device="cpu")
    assert ok.joint.out.weight.shape == (V, HJ)


def test_carry_flax_joint_rejects_a_wrong_rank():
    tree = {"pre": {"kernel": np.zeros((4, 6), np.float32),
                    "bias": np.zeros((6,), np.float32)},
            "out": {"kernel": np.zeros((6,), np.float32),
                    "bias": np.zeros((5,), np.float32)}}
    with pytest.raises(ValueError, match="leaf out/kernel must be a rank-2"):
        carry_flax_joint(tree, device="cpu")


def test_unknown_loss_mode_raises():
    model, params, batch = init_model(0, vocab_size=8, feat_dim=6, N=2, T=6,
                                      U=3, device="cpu", encoder_hidden=8,
                                      predictor_hidden=8, joint_hidden=8)
    with pytest.raises(ValueError, match="unknown loss_mode"):
        transducer_loss_fn(model, batch, loss_mode="padded")
    with pytest.raises(ValueError, match="unknown loss_mode"):
        make_train_step(model, torch.optim.AdamW(model.parameters()),
                        loss_mode="compact")


def test_models_exports():
    import warp_rnnt_tpu.models as jm

    shared = {"Encoder", "Predictor", "Transducer", "init_model",
              "make_train_step", "transducer_loss_fn", "Joint"}
    assert shared <= set(jm.__all__)
    assert shared | {"ConvBlock", "carry_flax_transducer",
                     "carry_flax_joint"} <= set(tm.__all__)


def test_modules_default_to_the_card():
    import inspect

    for fn in (tm.ConvBlock, tm.Encoder, tm.Predictor, tm.Transducer,
               tm.init_model, tm.carry_flax_transducer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_carry_rejects_a_leaf_of_the_wrong_shape():
    """A leaf whose shape does not fit the model the tree's other leaves
    size names its path (the GRU's three gates as one)."""
    tree = tc.flax_tree(0, V, F, HE)
    tree["params"]["joint"]["out"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="leaf joint/out/bias of shape"):
        carry_flax_transducer(tree, device="cpu")
    tree = tc.flax_tree(0, V, F, HE)
    tree["params"]["predictor"]["cell"]["hz"]["kernel"] = np.zeros(
        (HE, HE + 1), np.float32)
    with pytest.raises(ValueError, match=r"predictor/cell/\{hr,hz,hn\}/kernel"):
        carry_flax_transducer(tree, device="cpu")
    tree = tc.flax_tree(0, V, F, HE)
    del tree["params"]["encoder"]["conv_blocks_1"]
    with pytest.raises(ValueError, match="1 conv blocks of width 5"):
        carry_flax_transducer(tree, device="cpu")
