"""The dense gradient write against its least bytes: the (N, T, U, V) fp32
gradient written once and the (N, T, U, 2) cotangent read once a call,
over the card's bandwidth, divided by the trace's time in the kernels
named here (`ops/flat_kernels.py`'s, from `csrc/flat_write.cu`)."""

from portbench import counts, trace

KERNELS = ("flat_write_kernel",)


def read(ctx):
    if ctx["trace"] is None:
        return None
    ns = trace.kernel_ns(ctx["trace"].device, KERNELS)
    if ns == 0:
        return None
    c = ctx["cell"]
    nbytes = counts.grad_write_bytes(c["N"], c["T"], c["U"], c["V"]) * c["calls"]
    return 100.0 * nbytes / ctx["rates"][0] / (ns / 1e9)
