"""Utterances whose loss and gradient (and, in a train step, update)
completed in the window, over the window's seconds (host clock; the
device synchronised at the window's end)."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
