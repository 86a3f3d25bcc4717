"""The mean device span of a request, in ms: between CUDA events recorded
on the stream just before and just after each graph replay of the
window's requests."""


def read(ctx):
    spans = ctx["cell"].get("spans_s")
    if ctx["trace"] is None or not spans:
        return None
    return 1e3 * sum(spans) / ctx["calls"]
