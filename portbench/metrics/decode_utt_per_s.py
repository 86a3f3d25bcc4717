"""Utterances decoded in the window (their tokens, lengths and scores on
the host) over the window's seconds."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
