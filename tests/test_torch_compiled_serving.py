"""The streaming chunk's encoder step and `bench_joint`'s step compiled
through `utils.compiled_step` (the port's ``jax.jit``), on the CPU, where a
compiled step runs its function eagerly: the plain version.

  * A streaming session goes through `streaming.chunk_step` (the whole
    chunk compiled) once a chunk and once at the finish, and equals JAX's
    jitted `stream_step` /
    `stream_finish` on a carried fp32 tree (greedy and beam 3; tokens and
    lengths equal, beam scores within 1e-4, the tolerances of
    `tests/test_torch_streaming.py`).
  * Two sessions of one (N, C) on one model, fed in turns, each equal
    their own one-shot decode, bit for bit (`compiled_serving_cases.
    check_interleaved`); the card check's compiled-against-eager code
    runs here with both sides eager.
  * The chunk step's cache key changes with a parameter's address, N,
    C, the limit's kind (step or finish), ``xn`` given or not, and the
    dtype.
  * `bench_joint.compiled_joint_step` against JAX's ``jax.value_and_grad``
    of the same loss in its five modes, compact with the static bounds
    of JAX's bench (bf16: loss rtol
    2e-3, gradients within 2e-2 of the largest; the padded modes in fp32:
    rtol 1e-5, gradients within 5e-3 of the largest), full and random
    lengths; equal to `value_and_grad` bit for bit.
  * The compact mode refuses to compile without its static bounds (JAX's
    message).
The card's checks (compiled against eager bit for bit, interleaved
sessions, compact without its bounds failing the capture) are in
`tests/test_torch_compiled_serving_card.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu.models import stream_finish as jax_finish
from warp_rnnt_tpu.models import stream_init as jax_init
from warp_rnnt_tpu.models import stream_step as jax_step
from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
from warp_rnnt_tpu_torch.models import (
    init_model,
    stream_finish,
    stream_init,
    stream_step,
    streaming,
)
from warp_rnnt_tpu_torch.utils import compiled_step as cs

N, T, F, V, H, ML, C = 3, 23, 9, 29, 32, 20, 5  # chunks of 5, a tail of 3
XN = [23, 17, 9]


@pytest.fixture(scope="module")
def bf16_model():
    return init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=5,
                      device="cpu", encoder_hidden=H, predictor_hidden=H,
                      joint_hidden=H)[0]


def _feats(seed):
    return np.random.RandomState(seed).randn(N, T, F).astype(np.float32)


def _counting(monkeypatch):
    calls = []
    real = streaming.chunk_step

    def counted(model, spec, beam, finish, with_xn, *static):
        calls.append((finish, with_xn))
        return real(model, spec, beam, finish, with_xn, *static)

    monkeypatch.setattr(streaming, "chunk_step", counted)
    return calls


@pytest.mark.parametrize("beam", [0, 3])
def test_session_matches_jax_jit(beam, monkeypatch):
    feats = _feats(4)
    model, params, port = carried_pair("fp32", 5, feats, V, H)
    xn = np.array(XN, np.int32)
    jstep = jax.jit(lambda st, chunk, xn: jax_step(model, params, st, chunk,
                                                   xn=xn))
    jfinish = jax.jit(lambda st, xn: jax_finish(model, params, st, xn=xn))
    jst = jax_init(model, params, N, max_length=ML, beam_size=beam)
    for i in range(0, T, C):
        jst = jstep(jst, jnp.asarray(feats[:, i:i + C]), xn)
    want = jfinish(jst, xn)

    calls = _counting(monkeypatch)
    x, txn = torch.tensor(feats), torch.tensor(xn)
    st = stream_init(port, N, ML, beam_size=beam)
    for i in range(0, T, C):
        st = stream_step(port, st, x[:, i:i + C], xn=txn)
    got = stream_finish(port, st, xn=txn)
    chunks = -(-T // C)
    assert calls == [(False, True)] * chunks + [(True, True)]
    assert streaming.LAST_GRAPH == {"step": None, "finish": None}  # eager
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if beam:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("beam", [0, 3])
def test_interleaved_sessions_equal_one_shot(bf16_model, beam):
    feats = (torch.tensor(_feats(6)), torch.tensor(_feats(7)))
    xns = (torch.tensor(XN, dtype=torch.int32),
           torch.tensor(XN[::-1], dtype=torch.int32))
    lengths = csc.check_interleaved(bf16_model, feats, xns, ML, beam, C)
    assert len(lengths) == 2 and all(len(x) == N for x in lengths)


@pytest.mark.parametrize("with_xn", [False, True])
@pytest.mark.parametrize("beam", [0, 3])
def test_compiled_check_runs_on_cpu(bf16_model, beam, with_xn):
    xn = torch.tensor(XN, dtype=torch.int32) if with_xn else None
    r = csc.check_stream_compiled(bf16_model, torch.tensor(_feats(8)), xn,
                                  ML, beam, C)
    assert r["chunks"] == -(-T // C) and r["chunk_graphs"] == 0
    assert r["chunk_replays"] == [0] * r["chunks"]  # eager: no replays


def test_session_state_is_the_callers(bf16_model):
    """A state fed twice gives the same next state: nothing of it is
    written in place."""
    x = torch.tensor(_feats(9))
    st = stream_step(bf16_model, stream_init(bf16_model, N, ML), x[:, :C])
    before = [t.clone() for t in csc.leaves(st)]
    a = stream_step(bf16_model, st, x[:, C:2 * C])
    b = stream_step(bf16_model, st, x[:, C:2 * C])
    csc._equal("twice", a, b)
    csc._equal("the state", st, before)


def _key_args(model, n=N, c=C, finish=False, xn=False, dtype=torch.float32):
    st = stream_init(model, n, ML)
    leaves = streaming._leaves(st)
    spec = streaming._spec(leaves)
    x = () if finish else (torch.zeros(n, c, F, dtype=dtype),)
    args = (streaming._buffer(leaves, spec), *x)
    return spec, args + ((torch.zeros(n, dtype=torch.int32),) if xn else ())


def test_encoder_step_cache_key(bf16_model):
    def key(model=bf16_model, finish=False, xn=False, **kw):
        with torch.inference_mode():
            spec, args = _key_args(model, finish=finish, xn=xn, **kw)
            step = streaming.chunk_step(model, spec, False, finish, xn, 4, 0)
            return step._cache_key(args)

    base = key()
    assert key() == base
    fp32 = init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=5,
                      device="cpu", encoder_hidden=H, predictor_hidden=H,
                      joint_hidden=H, compute_dtype=torch.float32)[0]
    others = [key(n=N + 1), key(c=C + 1), key(finish=True), key(xn=True),
              key(dtype=torch.float64), key(model=fp32)]
    w = bf16_model.encoder.conv_blocks[1].conv.weight
    saved = w.data
    try:  # one parameter at a new address, the same values
        w.data = saved.clone()
        others.append(key())
    finally:
        w.data = saved
    assert key() == base
    assert len(set(others)) == len(others) and base not in others


def test_plain_is_scoped():
    assert not cs._EAGER_ON_CARD
    with cs._plain():
        assert cs._EAGER_ON_CARD
        with cs._plain():
            pass
        assert cs._EAGER_ON_CARD
    assert not cs._EAGER_ON_CARD


# ---- the joint step ---------------------------------------------------------

JN, JT, JU, JV, JH = 2, 6, 3, 12, 16


def _jax_loss_fn(mode, jjoint, ys, xn, yn):
    """JAX's `bench_joint.py` loss_fn(p, f, g) of ``mode``."""
    import flax.linen as nn

    from warp_rnnt_tpu import rnnt_loss, rnnt_loss_from_logits, rnnt_loss_joint
    from warp_rnnt_tpu.ops.fused_joint import rnnt_loss_fused_joint

    if mode == "compact":  # JAX's packing, from the lengths on the host
        n_idx, t_idx, u_idx = map(jnp.asarray, bj.compact_indices(xn, yn))
        ys_packed = jnp.concatenate([ys[i, :yn[i]] for i in range(len(yn))])

    def loss_fn(p, f, g):
        if mode == "compact":
            lp = jjoint.apply(p, f[n_idx, t_idx], g[n_idx, u_idx])
            return rnnt_loss(lp, ys_packed, xn, yn, reduction="mean",
                             compact=True, max_frames=f.shape[1],
                             max_labels=ys.shape[1])
        if mode == "log_softmax+gather":
            return rnnt_loss(jjoint.apply(p, f, g), ys, xn, yn,
                             reduction="mean", gather=True)
        if mode == "from_logits":
            return rnnt_loss_from_logits(jjoint.apply(p, f, g, normalize=False),
                                         ys, xn, yn, reduction="mean")
        pp = nn.unbox(p)["params"]
        fp = dict(w_pre=pp["pre"]["kernel"], b_pre=pp["pre"]["bias"],
                  w_out=pp["out"]["kernel"], b_out=pp["out"]["bias"])
        if mode == "auto":
            return rnnt_loss_joint(f, g, fp, ys, xn, yn, reduction="mean",
                                   layout="auto")
        return rnnt_loss_fused_joint(f, g, fp, ys, xn, yn, reduction="mean")
    return loss_fn


TOLS = {"bf16": (2e-3, 2e-2), "fp32": (1e-5, 5e-3)}
CASES = [(m, "bf16") for m in csc.JOINT_MODES] + [
    (m, "fp32") for m in ("log_softmax+gather", "from_logits")]


@pytest.mark.parametrize("rand_length", [False, True])
@pytest.mark.parametrize("mode,precision", CASES)
def test_compiled_joint_step_matches_jax(mode, precision, rand_length):
    from warp_rnnt_tpu.models.joint import Joint as JaxJoint

    f, g, ys, xn, yn = bj.make_inputs(0, JN, JT, JU, JH, rand_length,
                                      device="cpu")
    tree = bj.joint_tree(1, JH, JV)
    joint, _ = bj.carry_flax_joint(tree, device="cpu")
    jdtype = jnp.bfloat16
    if precision == "fp32":
        joint.compute_dtype, jdtype = torch.float32, jnp.float32
    step = bj.compiled_joint_step(mode, joint, f, ys, xn, yn)
    assert isinstance(step, cs.CompiledStep)
    loss, *grads = step(f, g)
    assert step.entry is None  # the CPU runs it eagerly
    packed = bj.pack(ys, xn, yn, JT, JU) if mode == "compact" else None
    want_loss, want_tree = bj.value_and_grad(mode, joint, f, g, ys, xn, yn,
                                             packed)
    assert torch.equal(loss, want_loss)
    tree_got = bj.grad_tree(*grads)

    jf, jg, jys = (jnp.asarray(t.numpy()) for t in (f, g, ys))
    loss_fn = _jax_loss_fn(mode, JaxJoint(vocab_size=JV, hidden=JH,
                                          compute_dtype=jdtype),
                           jys, xn.numpy(), yn.numpy())
    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree), jf, jg)
    loss_tol, grad_share = TOLS[precision]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_tol)
    for layer in ("pre", "out"):
        for name in ("kernel", "bias"):
            got = tree_got[layer][name]
            assert torch.equal(got, want_tree[layer][name])
            got = got.numpy()
            want = np.asarray(jgrads["params"][layer][name])
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=max(grad_share * np.abs(want).max(), 1e-7),
                err_msg=f"{mode} {precision} {layer}/{name}")


@pytest.mark.parametrize("mode", csc.JOINT_MODES)
def test_joint_check_runs_on_cpu(mode):
    case = csc.joint_case(JN, JT, JU, JV, JH, rand_length=True, device="cpu")
    assert csc.check_joint(mode, *case, profile=True) == {}


def test_compact_refuses_to_compile():
    """Without its static bounds: compact compiles with them (its check is
    in the mode list above), and a trace without them raises JAX's
    message, the host read it would need."""
    f, g, ys, xn, yn = bj.make_inputs(0, JN, JT, JU, JH, device="cpu")
    joint, _ = bj.carry_flax_joint(bj.joint_tree(1, JH, JV), device="cpu")
    assert "compact" in csc.JOINT_MODES
    packed = (*bj.pack(ys, xn, yn, JT, JU)[:4], None, None)
    with cs._tracing(), pytest.raises(
            ValueError, match="requires static max_frames / max_labels"):
        bj.loss_grad_fn("compact", joint, ys, xn, yn, packed)(f, g)


def test_joint_step_key():
    f, g, ys, xn, yn = bj.make_inputs(0, JN, JT, JU, JH, device="cpu")
    joint, _ = bj.carry_flax_joint(bj.joint_tree(1, JH, JV), device="cpu")
    other, _ = bj.carry_flax_joint(bj.joint_tree(1, JH, JV), device="cpu")
    keys = {bj.step_key(m, j, f, ys, xn, yn)
            for m in csc.JOINT_MODES for j in (joint, other)}
    assert len(keys) == 2 * len(csc.JOINT_MODES)
    assert bj.step_key("auto", joint, f, ys, xn, yn)[2] == "padded"  # CPU


@pytest.mark.parametrize("bench", ["stream", "joint", "turns"])
def test_serving_benchmarks_need_cuda(bench):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from warp_rnnt_tpu_torch.benchmarks import bench_streaming, serving_turns

    with pytest.raises(SystemExit, match="CUDA device"):
        if bench == "stream":
            bench_streaming.bench_streaming(N=2, C=4, V=12, hidden=16,
                                            eager=True)
        elif bench == "joint":
            bj.bench_joint(N=2, T=6, U=3, V=12, H=16, mode="fused",
                           compiled=False)
        else:
            serving_turns.main(["--only", "joint"])
