"""The compiled streaming chunk and joint step's checks, in one place:
`chip_smoke.py` (`phase_compiled_serving`) runs them at
`bench_streaming`'s and `bench_joint`'s widths and
`tests/test_torch_compiled_serving_card.py` at small ones; on CPU tensors
both sides run eagerly, which the CPU tests use to run this code.  Each
check raises an AssertionError on a failure.

  * `check_stream_compiled`: a session whose chunks replay their CUDA
    graphs (`streaming.chunk_step`: the encoder's step and the drain's
    while node in one graph) against the same session run eagerly
    (`compiled_step._plain`, the drain on its own while node), chunk by
    chunk: the whole state (encoder carry, decoder state) after every
    `stream_step`, then `stream_finish`'s tokens, lengths and beam
    scores, bit for bit (``torch.equal``); each chunk replays its graph
    once.
  * `check_interleaved`: two sessions of one (N, C) on one model, fed in
    turns, each equal to its own one-shot decode (tokens, lengths, beam
    scores), bit for bit.
  * `check_joint`: `bench_joint`'s step in one mode compiled
    (`bench_joint.compiled_joint_step`) against the very function called
    eagerly, bit for bit on the loss and the four gradients, on the
    capture's inputs and on new f and g copied into the static buffers;
    the capture ms, the graph's pool MiB and, with ``profile``, the
    kernels of a replay and of an eager call.
  * `check_compact_needs_bounds`: the compact mode without its static
    bounds (``max_frames``, ``max_labels``) forced through
    `utils.compiled_step` fails its capture with JAX's message (the host
    read it would need) and leaves no entry (on CPU tensors the step runs
    eagerly inside `compiled_step._tracing`).
"""

from __future__ import annotations

import contextlib

import torch

from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    stream_finish,
    stream_init,
    stream_step,
)
from warp_rnnt_tpu_torch.utils import compiled_step as cs

JOINT_MODES = bj.MODES  # every mode compiles


def leaves(tree):
    """The tensors of a session state (dicts and tuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for x in tree for t in leaves(x)]


def _equal(what, got, want):
    got, want = leaves(got), leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tensors against"
                             f" {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: tensor {i} ({tuple(w.shape)},"
                                 f" {w.dtype}) differs")


def _chunks(T, C):
    return [(i, min(i + C, T)) for i in range(0, T, C)]


def check_stream_compiled(model, feats, xn, max_length, beam, C):
    """`check_stream_compiled` of the module docstring, chunks of C (the
    last one ragged where C does not divide T).  Returns {"chunks",
    "chunk_replays" (a stream_step's, each chunk), "chunk_graphs"
    (captured meanwhile)}."""
    N, T, _ = feats.shape
    tag = f"compiled stream beam={beam} C={C}"
    st = stream_init(model, N, max_length, beam_size=beam)
    with cs._plain():
        ref = stream_init(model, N, max_length, beam_size=beam)
    _equal(f"{tag} init", st, ref)
    replays, captures = [], cs.STATS["captures"]
    for i, (a, b) in enumerate(_chunks(T, C)):
        before = cs.STATS["replays"]
        st = stream_step(model, st, feats[:, a:b], xn=xn)
        replays.append(cs.STATS["replays"] - before)
        with cs._plain():
            ref = stream_step(model, ref, feats[:, a:b], xn=xn)
        _equal(f"{tag} chunk {i}", st, ref)
    got = stream_finish(model, st, xn=xn)
    with cs._plain():
        want = stream_finish(model, ref, xn=xn)
    _equal(f"{tag} finish", got, want)
    on_card = feats.is_cuda
    if on_card and replays != [1] * len(replays):
        raise AssertionError(f"{tag}: replays a chunk {replays}")
    return {"chunks": len(replays), "chunk_replays": replays,
            "chunk_graphs": cs.STATS["captures"] - captures}


def one_shot(model, feats, xn, max_length, beam):
    """The one-shot decode a session must equal."""
    if beam:
        return beam_decode(model, feats, xn, max_length, beam_size=beam)
    return greedy_decode(model, feats, xn, max_length)


def check_interleaved(model, feats, xns, max_length, beam, C):
    """Sessions on each (N, T, F) features of ``feats`` (one shape), with
    the lengths ``xns``, fed chunk by chunk in turns; each result against
    its one-shot decode.  Returns the sessions' lengths."""
    T = feats[0].shape[1]
    states = [stream_init(model, f.shape[0], max_length, beam_size=beam)
              for f in feats]
    for a, b in _chunks(T, C):
        for s, (f, xn) in enumerate(zip(feats, xns)):
            states[s] = stream_step(model, states[s], f[:, a:b], xn=xn)
    out = []
    for s, (f, xn) in enumerate(zip(feats, xns)):
        got = stream_finish(model, states[s], xn=xn)[:-1]
        want = one_shot(model, f, xn, max_length, beam)
        same = [torch.equal(g, w) for g, w in zip(got, want)]
        if not all(same):
            raise AssertionError(f"interleaved session {s} beam={beam}"
                                 f" C={C}: tokens, lengths[, scores] equal"
                                 f" one-shot {same}")
        out.append(got[1].tolist())
    return out


def joint_case(N, T, U, V, H, rand_length=False, seed=0, device="cuda"):
    """`bench_joint`'s inputs and joint: (joint, f, g, ys, xn, yn)."""
    f, g, ys, xn, yn = bj.make_inputs(seed, N, T, U, H, rand_length, device)
    joint, _ = bj.carry_flax_joint(bj.joint_tree(seed + 1, H, V),
                                   device=device)
    return joint, f, g, ys, xn, yn


def _kernels(call):
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile

    call()
    torch.cuda.synchronize()
    r = device_profile(call, 10)
    if not r["complete"]:
        raise AssertionError("a joint step's profile is incomplete")
    return ({key: n for _, n, key in r["rows"]}, r["busy_ms"],
            {key: ms for ms, _, key in r["rows"]})


def check_joint(mode, joint, f, g, ys, xn, yn, seed=0, profile=False):
    """`check_joint` of the module docstring.  Returns {"capture_ms",
    "pool_mib", and with ``profile`` "kernels" ({"eager", "compiled"}:
    {kernel: launches a call}), "kernel_ms" (likewise, device ms a call)
    and "busy_ms" ({"eager", "compiled"})}; on CPU tensors {} (both sides
    eager)."""
    packed = bj.pack(ys, xn, yn, f.shape[1], ys.shape[1]) if (
        mode == "compact") else None
    fn = bj.loss_grad_fn(mode, joint, ys, xn, yn, packed)
    step = bj.compiled_joint_step(mode, joint, f, ys, xn, yn, packed)
    gen = torch.Generator(device=f.device).manual_seed(seed + 99)
    new = (torch.randn(f.shape, generator=gen, device=f.device),
           torch.randn(g.shape, generator=gen, device=f.device))
    names = ("loss", "d w_pre", "d b_pre", "d w_out", "d b_out")
    out = {}
    try:
        got = step(f, g)
        for what, args in (("capture's inputs", (f, g)), ("new inputs", new)):
            if what == "new inputs":
                got = step(*args)
            want = fn(*args)
            for name, a, b in zip(names, got, want):
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                        a, b):
                    err = (a.double() - b.double()).abs().max().item()
                    raise AssertionError(f"joint {mode} on the {what}:"
                                         f" compiled {name} differs from"
                                         f" eager (max abs err {err})")
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"joint {mode}: not finite")
        if step.entry is None:
            return out
        out = {"capture_ms": step.entry.capture_ms,
               "pool_mib": step.entry.pool_bytes / 2**20}
        if profile:
            static = step.entry.args
            eager, busy_e, ms_e = _kernels(lambda: fn(f, g))
            compiled, busy_c, ms_c = _kernels(lambda: step(*static))
            out["kernels"] = {"eager": eager, "compiled": compiled}
            out["busy_ms"] = {"eager": busy_e, "compiled": busy_c}
            out["kernel_ms"] = {"eager": ms_e, "compiled": ms_c}
    finally:
        step.release()
    return out


def check_compact_needs_bounds(joint, f, g, ys, xn, yn):
    """`check_compact_needs_bounds` of the module docstring; returns the
    refusal's message."""
    packed = (*bj.pack(ys, xn, yn, f.shape[1], ys.shape[1])[:4], None, None)
    step = cs.compiled_step(bj.loss_grad_fn("compact", joint, ys, xn, yn,
                                            packed),
                            key=("compiled_serving_cases.compact",
                                 *bj.step_key("compact", joint, f, ys, xn,
                                              yn, packed)))
    try:
        with contextlib.nullcontext() if f.is_cuda else cs._tracing():
            step(f, g)  # on the CPU: eager, as traced
    except ValueError as e:
        why = str(e)
    else:
        raise AssertionError("compact without static bounds: the capture"
                             " did not raise")
    if "requires static max_frames / max_labels" not in why:
        raise AssertionError(f"compact without static bounds: {why}")
    if step.entry is not None or any(
            e.key[0] == step.key for e in cs.entries()):
        raise AssertionError("compact: a failed capture left an entry")
    if f.is_cuda:
        torch.cuda.synchronize()
    return why
