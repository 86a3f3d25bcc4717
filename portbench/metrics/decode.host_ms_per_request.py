"""The mean of each request's host latency less its device span, in ms:
the compiled step's key and the input copies before the replay, the read
of the loop's count and the answers' copies to the host after it."""


def read(ctx):
    spans = ctx["cell"].get("spans_s")
    if ctx["trace"] is None or not spans:
        return None
    return 1e3 * (sum(ctx["latencies_s"]) - sum(spans)) / ctx["calls"]
