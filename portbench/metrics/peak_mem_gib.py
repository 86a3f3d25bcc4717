"""The device memory the process held at its peak over the window, in GiB:
`torch.cuda.max_memory_reserved`, reset after the warm-up.  Reserved and
not allocated, because a compiled step's tensors live in its CUDA graph's
private pool, which the allocator counts as reserved only."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
