"""The whole loss and gradient call's share of its roofline, the card's
bandwidth (the loss runs no products, so no FLOP peak binds it): the call's
least bytes (the dense fp32 gradient written once, two fp32 log-probs a
valid cell read once) over the bandwidth, divided by the window's
seconds.  It reads no kernel name, so
it still measures a call whose kernels are rewritten or merged."""

from portbench import counts


def read(ctx):
    if ctx["trace"] is None:
        return None
    c = ctx["cell"]
    nbytes = counts.loss_call_bytes(c["N"], c["T"], c["U"], c["V"],
                                    c["valid_cells"], c["calls"])
    return 100.0 * nbytes / ctx["rates"][0] / ctx["window_s"]
