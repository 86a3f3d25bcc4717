"""Where the host's time goes in a decode and a streaming chunk on a CUDA
device, part by part, for comparing two trees in turns.

    python -m warp_rnnt_tpu_torch.benchmarks.decode_host_path [--tag x]
        [--calls K]

Each part is a span (`torch.profiler.record_function`) put around one
function of the tree while it runs (`spans`): the span's host µs a call
is its CPU time over K calls under the profiler's host side (the spans'
own cost included, a few µs each).  The functions, where the tree has
them (a part the tree lacks reads None):

  * "encode" `Transducer.encode`; "state_init" `greedy_state_init` /
    `beam_state_init`; "consts" `decoding.decode_consts` (the key over
    the parameters, or the casts); "pad" `decoding.pad_frames`; "drain"
    `decoding.run_drain`;
  * the device loop's: "while_loop"; "graphed" (`_graphed`: the loop
    outside a capture) and inside it "cache_key", "load" (the copies in,
    the count, the bound), "launch" (the while node), "read" (the one
    host read, which waits for the device);
  * the compiled step's: "compiled_call" (`CompiledStep.__call__`: its
    key, the copies of the arguments, the replay) and "replay" (the
    graph's replay and its after-replay checks: the loop's read);
    "module_key" (`compiled_step.module_key`: the walk over the model's
    parameters and buffers that keys a compiled decode, a chunk and a
    drain, every call);
  * the chunk's: "encoder_step" (`streaming._encode`, where the tree
    compiles the encoder's step alone: its replay and the carry's
    clones) or "chunk" (`streaming._chunk`: the whole chunk's step, the
    state's buffer cloned out and viewed).

Derived: "clones" = graphed - (cache_key + load + launch + read) (the
state's clones out of the loop's buffers, the cache's upkeep);
"carry_clones" = encoder_step - compiled_call; "chunk_other" = chunk -
compiled_call (the buffer's check, its clone and views); "call_other" =
compiled_call - replay (the key and the copies in).

Cases: "greedy" and "beam" (beam 4): the eager decode (`greedy_decode`,
`beam_decode`) at `bench_decode`'s width (N=32, T=400, V=1024, hidden
512; `init_model` seed 0, features normal from seed 1, every frame
valid); "compiled greedy", "compiled beam": the compiled decode where
the tree has it; "chunk greedy", "chunk beam": a steady `stream_step`
at `bench_streaming`'s width (N=8, C=16, token buffers full).  Beside
the parts, "wall_us": a call's host µs without the profiler (the read
waits for the device, so this is the call's whole time).  One JSON line
a case, with the tag and the card.  Reads only entry points that older
trees have: copy it into an older tree's `benchmarks/` and run it there
(that tree's root as the working directory).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time

import torch

CALLS = 20
# (part, module, attribute): a function of the module, or "Class.method"
TARGETS = (
    ("encode", "models.transducer", "Transducer.encode"),
    ("state_init", "models.decoding", "greedy_state_init"),
    ("state_init", "models.beam_search", "beam_state_init"),
    ("consts", "models.decoding", "decode_consts"),
    ("pad", "models.decoding", "pad_frames"),
    ("drain", "models.decoding", "run_drain"),
    ("while_loop", "utils.device_loop", "while_loop"),
    ("graphed", "utils.device_loop", "_graphed"),
    ("cache_key", "utils.device_loop", "cache_key"),
    ("load", "utils.device_loop", "_Entry.load"),
    ("launch", "utils.device_loop", "_Entry.launch"),
    ("read", "utils.device_loop", "_Entry.read"),
    ("compiled_call", "utils.compiled_step", "CompiledStep.__call__"),
    ("module_key", "utils.compiled_step", "module_key"),
    ("replay", "utils.compiled_step", "_Entry.replay"),
    ("encoder_step", "models.streaming", "_encode"),
    ("chunk", "models.streaming", "_chunk"),
)
DERIVED = {"clones": ("graphed", ("cache_key", "load", "launch", "read")),
           "carry_clones": ("encoder_step", ("compiled_call",)),
           "chunk_other": ("chunk", ("compiled_call",)),
           "call_other": ("compiled_call", ("replay",))}


def _spanned(part, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(f"part:{part}"):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def spans():
    """Within the block each function of `TARGETS` that the tree has runs
    inside a span named ``part:<part>``, under every name the package's
    modules bind it to."""
    import importlib

    undo = []
    for part, mod_name, attr in TARGETS:
        try:
            mod = importlib.import_module(f"warp_rnnt_tpu_torch.{mod_name}")
        except ImportError:
            continue
        owner, _, name = attr.rpartition(".")
        holder = getattr(mod, owner) if owner else mod
        real = getattr(holder, name, None)
        if real is None:
            continue
        wrapped = _spanned(part, real)
        holders = [holder] if owner else [
            m for key, m in list(sys.modules.items())
            if key.startswith("warp_rnnt_tpu_torch") and m is not None
            and getattr(m, name, None) is real]
        for h in holders:
            setattr(h, name, wrapped)
            undo.append((h, name, real))
    try:
        yield
    finally:
        for h, name, real in reversed(undo):
            setattr(h, name, real)


def parts_us(fn, calls=CALLS):
    """{part: host µs a call} of ``fn()`` (module docstring), the derived
    parts included where their readings are, and "wall_us"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = (time.perf_counter() - t0) / calls * 1e6
    with spans():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    us = {ev.key[len("part:"):]: ev.cpu_time_total / calls
          for ev in prof.key_averages() if ev.key.startswith("part:")}
    for name, (whole, subs) in DERIVED.items():
        if whole in us:
            us[name] = us[whole] - sum(us.get(s, 0.0) for s in subs)
    return {**us, "wall_us": wall}


@torch.inference_mode()
def cases():
    """{case: fn} (module docstring)."""
    from warp_rnnt_tpu_torch.models import (
        beam_decode,
        beam_search,
        decoding,
        greedy_decode,
        init_model,
        stream_init,
        streaming,
    )

    N, T, V, F, H, L, B = 32, 400, 1024, 80, 512, 100, 4
    model = init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=8,
                       device="cuda", encoder_hidden=H, predictor_hidden=H,
                       joint_hidden=H)[0]
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn((N, T, F), generator=gen).to("cuda")
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    out = {"greedy": lambda: greedy_decode(model, feats, xn, L),
           "beam": lambda: beam_decode(model, feats, xn, L, beam_size=B)}
    if hasattr(decoding, "compiled_greedy_decode"):
        out["compiled greedy"] = lambda: decoding.compiled_greedy_decode(
            model, feats, xn, L)
        out["compiled beam"] = lambda: beam_search.compiled_beam_decode(
            model, feats, xn, L, beam_size=B)
    SN, C = 8, 16
    chunk = torch.randn((SN, C, F), generator=gen).to("cuda")
    for beam, name in ((0, "chunk greedy"), (B, "chunk beam")):
        box = [stream_init(model, SN, L, beam_size=beam)]
        for _ in range(L // C + 4):  # the token buffers full
            box[0] = streaming.stream_step(model, box[0], chunk)

        def one(box=box):
            box[0] = streaming.stream_step(model, box[0], chunk)

        out[name] = one
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--calls", type=int, default=CALLS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_host_path needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from warp_rnnt_tpu_torch.utils.profiling import card_line

    card = card_line()
    for name, fn in cases().items():
        with torch.inference_mode():
            us = parts_us(fn, args.calls)
        print(json.dumps({"tag": args.tag, "case": name, "card": card,
                          "us": {k: round(v, 2) for k, v in us.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
