"""Operations on the card in the traced window (kernels, copies, sets)
over the calls made in it."""


def read(ctx):
    if ctx["trace"] is None or not ctx["trace"].device:
        return None
    return len(ctx["trace"].device) / ctx["cell"]["calls"]
