"""The whole train step's share of the card's peak: the model's least
operations a step (`counts.transducer_flops`: forward once, backward
twice, the joint's output layer on the valid cells only) over the dense
bf16 tensor-core peak, divided by the window's seconds."""

from portbench import counts


def read(ctx):
    if ctx["trace"] is None:
        return None
    c = ctx["cell"]
    flops = counts.transducer_flops(c["N"], c["T"], c["U"], c["feat_dim"],
                                    c["hidden"], c["joint"], c["V"],
                                    c["blocks"], c["kernel"], 0) * c["calls"]
    flops += counts.transducer_flops(0, 0, 0, 0, 0, c["joint"], c["V"], 0, 0,
                                     c["valid_cells"])
    return 100.0 * flops / ctx["rates"][2] / ctx["window_s"]
