"""Device ms of the CPC loss's forward inside a step (predictions, the
negatives' gather, InfoNCE): the program's ``cpc.loss`` span under its
``train.step`` root, mean a step of the traced stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.step", ("cpc.loss",))
