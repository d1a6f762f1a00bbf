"""Share of the gru_backward kernels' roofline from shapes, by their device time a call."""

from vapbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "gru_backward")
