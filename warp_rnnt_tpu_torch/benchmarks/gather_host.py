"""Where the host time of one gather call goes, on a CUDA device.

    python -m warp_rnnt_tpu_torch.benchmarks.gather_host [N]

At T=150, U=21, V=5000 fp32 (`exp_gather`'s shape; N=32 by default), it
prints the host microseconds per call (`timing.bench_host`: the calls
queued behind a device-side sleep, so none waits for the device) of each
gather wrapper of `ops.gather_kernels`, of the one `torch.gather` call that
gives the same values (the library yardstick), of the main path's plain
formulation (a `torch.gather` and a stack), and of the pieces a wrapper's
host path is made of: tensor checks, the output's allocation, reading the
current stream, entering the device context, a ctypes call.  It reads the
package it imports through getattr, so the same script also reads an
earlier version of `gather_kernels` (copy this file and `timing.py` into
that version's `benchmarks/` and run it there).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from warp_rnnt_tpu_torch.benchmarks import exp_gather as eg
from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.ops import gather_kernels as gk


def _device_context(dev):
    with torch.cuda.device(dev):
        pass


def pieces(d):
    """{name: (fn, args)}: the wrappers, their library calls and the parts
    of a host path, on the operands of `exp_gather.make`."""
    xs, xs3, lab = d["xs"], d["xs3"], d["labels"]
    n, t, u = xs.shape[:3]
    dev = xs.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    cols = gk.blank_label_cols(lab, eg.BLANK, eg.V)
    idx_cols = cols.long()[:, None, :].expand(n, t, 2 * u)
    idx4 = lab.long()[:, None, :, None].expand(n, t, u, 1)
    out = {
        "gather_columns_flat": (gk.gather_columns_flat, (xs3, cols)),
        "gather_fwd": (gk.gather_fwd, (xs, lab, eg.BLANK)),
        "gather_fwd_sparse": (gk.gather_fwd_sparse, (xs3, lab, eg.BLANK, eg.V)),
        "torch.gather (N, T, 2U)": (torch.gather, (xs3, 2, idx_cols)),
        "main path plain: torch.gather + stack": (eg.taa4d, (d,)),
        "torch.gather (N, T, U, 1)": (torch.gather, (xs, 3, idx4)),
        "torch.empty (2, N, T, U)": (
            lambda: torch.empty((2, n, t, u), dtype=torch.float32, device=dev),
            ()),
        "x.new_empty (N, T, U, 2)": (lambda: xs.new_empty((n, t, u, 2)), ()),
        "torch.cuda.current_stream(dev).cuda_stream": (
            lambda: torch.cuda.current_stream(dev).cuda_stream, ()),
        "torch.cuda.current_device()": (torch.cuda.current_device, ()),
        "with torch.cuda.device(dev)": (_device_context, (dev,)),
        "3 x data_ptr()": (lambda: (xs.data_ptr(), lab.data_ptr(),
                                    cols.data_ptr()), ()),
    }
    if hasattr(gk, "gather_lattice"):
        out["gather_lattice"] = (gk.gather_lattice, (xs, lab, eg.BLANK))
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        out["torch._C._cuda_getCurrentRawStream(i)"] = (raw, (idx,))
    if hasattr(gk, "_check_labels"):
        out["_check_labels"] = (gk._check_labels, (xs, 4, lab, eg.BLANK, eg.V))
    if hasattr(gk, "_launch_ready"):
        out["_launch_ready"] = (gk._launch_ready,
                                (xs, lab, "labels_ext", n * t * 2 * u))
    if hasattr(gk, "_ready"):
        out["_ready"] = (gk._ready, (xs, lab, gk._LATTICE, eg.BLANK, eg.V))
    lib = gk._build.load("gather")
    err = lib.rnnt_gather_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    out["ctypes call, 1 int (no launch)"] = (err, (0,))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 32
    if not torch.cuda.is_available():
        raise SystemExit("gather_host needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    d = eg.make(n, "cuda", eg.SEED)
    res = {}
    for name, (fn, args) in pieces(d).items():
        res[name] = timing.bench_host(fn, args)
        print(f"host us/call {name}: {res[name]:.2f}  [{card}]")
    print(json.dumps({"gather_host_us": res, "N": n, "card": card,
                      "module": gk.__file__}))


if __name__ == "__main__":
    main()
