"""Seconds from the process's start to the first timed call: imports,
the kernels' build or load, inputs and weights, warm-up and captures."""


def read(ctx):
    return ctx["setup_s"]
