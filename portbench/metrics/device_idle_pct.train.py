"""The share of the traced window in which no operation ran on the card:
100 * (1 - union of the device's intervals / window)."""

from portbench import trace


def read(ctx):
    if ctx["trace"] is None or not ctx["trace"].device:
        return None
    busy = trace.busy_ns(ctx["trace"].device) / 1e9
    return 100.0 * (1.0 - busy / ctx["window_s"])
