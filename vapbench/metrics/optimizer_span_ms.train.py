"""Device ms of the optimizer's update inside a train step: the program's
``train.optimizer`` span under its ``train.step`` root, mean a step of the
traced stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train.step", ("train.optimizer",))
