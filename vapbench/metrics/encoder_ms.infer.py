"""ms of the encoder stage called alone, between CUDA events."""

from vapbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "encoder")
