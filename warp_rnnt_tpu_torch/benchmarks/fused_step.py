"""One fused joint loss+grad step on a CUDA device: chained ms, peak device
memory, and under the profiler the kernels a call, device busy ms and idle
share.

    python -m warp_rnnt_tpu_torch.benchmarks.fused_step [--H 256] [--V 5000]
                                                        [--N 16] [--tag x]

By default the fused slice of `chip_smoke.py`: N=16, T=150, U=21 (20
labels + 1), V=5000, H=F=256, "add" joint, full lengths, seeded normal
parameters and inputs.  It reads only the public entry point
`rnnt_loss_fused_joint` and `benchmarks.timing` / `benchmarks.profile_loss`,
so a copy placed in an older tree's `benchmarks/` and run there times that
tree: compare two trees in one call, in turns (old, new, new, old).
Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from warp_rnnt_tpu_torch import rnnt_loss_fused_joint
from warp_rnnt_tpu_torch.benchmarks import timing
from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step

SEED = 0


def make_step(N, T, U, V, H, F, seed=SEED):
    """(step, f): step(x) runs loss+grad with encoder output x and returns
    (loss, x.grad)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    params = {"w_pre": normal(F, H, scale=F ** -0.5),
              "b_pre": normal(H, scale=0.1),
              "w_out": normal(H, V, scale=H ** -0.5),
              "b_out": normal(V, scale=0.1)}
    params = {k: v.requires_grad_() for k, v in params.items()}
    f, g = normal(N, T, F), normal(N, U, F)
    labels = torch.randint(1, V, (N, U - 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    yn = torch.full((N,), U - 1, dtype=torch.int32, device="cuda")

    def step(x):
        x = x.detach().requires_grad_()
        for p in params.values():
            p.grad = None
        loss = rnnt_loss_fused_joint(x, g, params, labels, xn, yn,
                                     reduction="mean")
        loss.backward()
        return loss.detach(), x.grad

    return step, f


def measure(N=16, T=150, U=21, V=5000, H=256, F=256, iters=10):
    """{"ms", "peak_bytes", "kernels_per_call", "busy_ms", "idle_share"}."""
    if not torch.cuda.is_available():
        raise SystemExit("fused_step needs a CUDA device")
    step, f = make_step(N, T, U, V, H, F)
    step(f)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(f)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = timing.bench_grad_chain(step, f, iters)
    prof = profile_step(lambda: step(f))
    return {"ms": ms, "peak_bytes": peak,
            "kernels_per_call": prof["kernels_per_call"],
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "device": torch.cuda.get_device_name(0)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in (("N", 16), ("T", 150), ("U", 21), ("V", 5000),
                          ("H", 256), ("F", 256)):
        parser.add_argument(f"--{name}", type=int, default=default)
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    dims = {k: getattr(args, k) for k in "NTUVHF"}
    print(json.dumps({"tag": args.tag, **dims, **measure(**dims)}))


if __name__ == "__main__":
    main()
