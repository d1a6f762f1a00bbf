"""Host ms of the CPC negatives a step: their draw on the CPU generator
(``cpc.negatives``) and their copy to the card (``cpc.negatives_h2d``, which
waits for the card where the copy is pageable), mean a step of the traced
stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.step", ("cpc.negatives", "cpc.negatives_h2d"), clock="host")
