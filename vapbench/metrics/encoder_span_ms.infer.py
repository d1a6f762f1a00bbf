"""Device ms of the encoder inside a ``VapModel.probs`` call: the program's
``vap.encoder`` span under its ``vap.probs`` root, mean a call of the traced
stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "vap.probs", ("vap.encoder",))
