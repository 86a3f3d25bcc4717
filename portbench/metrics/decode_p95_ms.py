"""The 95th percentile of the latencies of all requests in the window,
from the call to its answers on the host, in ms (linear interpolation
between the two nearest ranks)."""


def read(ctx):
    lat = sorted(ctx["latencies_s"])
    if not lat:
        return None
    pos = 0.95 * (len(lat) - 1)
    i = int(pos)
    j = min(i + 1, len(lat) - 1)
    return 1e3 * (lat[i] + (lat[j] - lat[i]) * (pos - i))
