"""The share of the traced window outside the requests' device spans:
100 * (1 - the sum of the spans between CUDA events recorded on the
stream just before and just after each graph replay / window).  The
profiler's trace misses the kernels inside a conditional graph node's
body, so the spans stand in for it; the host's work before a replay and
its read after it fall outside them."""


def read(ctx):
    spans = ctx["cell"].get("spans_s")
    if ctx["trace"] is None or not spans:
        return None
    return 100.0 * (1.0 - sum(spans) / ctx["window_s"])
