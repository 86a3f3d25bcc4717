"""The streaming chunk and the joint step of one tree on a CUDA device, for
comparing two trees in turns.

    python -m warp_rnnt_tpu_torch.benchmarks.serving_turns [--tag x]
        [--only stream,joint] [--eager]

Prints one JSON line a measurement, each with the tag:
  * "stream": `bench_streaming.bench_streaming` at its defaults (N=8,
    C=16, V=1024, hidden 512), greedy and beam 4, on one model (`init_model`
    seed 0) for the whole process (a tree's keys: "chunk_graphs" where
    the whole chunk is compiled, "encoder_graphs" and "encoder_host_us"
    where the encoder's step alone is).
  * "joint": `bench_joint.bench_joint` at its defaults (N=16, T=150, U=20,
    V=5000, H=256, full lengths) in "log_softmax+gather", "from_logits",
    "fused" and "auto".

In a tree that compiles them (`bench_streaming` takes ``eager``,
`bench_joint` ``compiled``) the readings come in pairs, eager and
compiled, timed in turns: eager, compiled, compiled, eager; ``--eager``
reads the eager side only, the readings an older tree gives.  The eager
readings call only entry points that older trees have, so a copy of this
file placed in an older tree's `benchmarks/` and run there (that tree's
root on PYTHONPATH) times that tree: parent, change, change, parent, one
process each.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json

import torch

JOINT_MODES = ("log_softmax+gather", "from_logits", "fused", "auto")
PARTS = ("stream", "joint")
# the keys kept from each reading
STREAM_KEYS = ("chunk_ms", "compiled", "iterations_per_chunk",
               "host_reads_per_chunk", "graph_replays_per_chunk",
               "chunk_graphs", "encoder_graphs", "encoder_host_us",
               "kernels_per_chunk", "busy_ms", "idle_share", "peak_mb")
JOINT_KEYS = ("step_ms", "compiled", "capture_ms", "pool_mib",
              "kernels_per_call", "busy_ms", "idle_share", "profile_complete",
              "peak_hbm_mb", "route", "power_limit")


def _takes(fn, name):
    return name in inspect.signature(fn).parameters


def _turns(read, pairs):
    """With ``pairs``, {"eager": [r, r], "compiled": [r, r]} read eager,
    compiled, compiled, eager by ``read(compiled)``; else {"eager": [r]}
    (``read(False)``)."""
    if not pairs:
        return {"eager": [read(False)]}
    out = {"eager": [], "compiled": []}
    for compiled in (False, True, True, False):
        out["compiled" if compiled else "eager"].append(read(compiled))
        torch.cuda.empty_cache()
    return out


def _keep(r, keys):
    return {k: r.get(k) for k in keys}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--only", default=",".join(PARTS))
    parser.add_argument("--eager", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving_turns needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = args.only.split(",")
    dev = torch.cuda.get_device_name(0)

    def emit(what, r):
        print(json.dumps({"tag": args.tag, "what": what, "device": dev, **r}),
              flush=True)

    if "stream" in parts:
        from warp_rnnt_tpu_torch.benchmarks import bench_streaming as bs
        from warp_rnnt_tpu_torch.models import init_model

        compiles = _takes(bs.bench_streaming, "eager")
        pairs = compiles and not args.eager
        model = init_model(0, vocab_size=1024, feat_dim=80, N=8, T=16, U=8,
                           device="cuda", encoder_hidden=512,
                           predictor_hidden=512, joint_hidden=512)[0]
        for beam in (0, 4):
            def read(compiled, beam=beam):
                kw = {"eager": not compiled} if compiles else {}
                return _keep(bs.bench_streaming(beam=beam, model=model, **kw),
                             STREAM_KEYS)
            emit("stream", {"beam": beam, **_turns(read, pairs)})
    if "joint" in parts:
        from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj

        compiles = _takes(bj.bench_joint, "compiled")
        pairs = compiles and not args.eager
        for mode in JOINT_MODES:
            def read(compiled, mode=mode):
                kw = {"compiled": compiled} if compiles else {}
                return _keep(bj.bench_joint(mode=mode, **kw), JOINT_KEYS)
            emit("joint", {"mode": mode, **_turns(read, pairs)})


if __name__ == "__main__":
    main()
