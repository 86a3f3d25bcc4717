"""The lattice sweep and its epilogue against their least bytes: two fp32
log-probs read and two fp32 gradients written a valid cell, over the
card's bandwidth, divided by the trace's time in the kernels named here
(`ops/cuda_impl.py`'s, from `csrc/lattice.cu`)."""

from portbench import counts, trace

KERNELS = ("lattice_kernel", "epilogue_kernel")


def read(ctx):
    if ctx["trace"] is None:
        return None
    ns = trace.kernel_ns(ctx["trace"].device, KERNELS)
    if ns == 0:
        return None
    least_s = counts.lattice_bytes(ctx["cell"]["valid_cells"]) / ctx["rates"][0]
    return 100.0 * least_s / (ns / 1e9)
