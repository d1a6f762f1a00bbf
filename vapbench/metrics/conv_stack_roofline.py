"""Share of the conv_stack kernels' roofline from shapes, by their device time a call."""

from vapbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "conv_stack")
