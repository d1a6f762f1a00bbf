"""MB the program copies from host memory to the card a step: its
``h2d_bytes`` counter under the ``train.step`` root (the CPC negatives'
indices), mean a step of the traced stretch."""

from vapbench.program_spans import counter


def read(ctx):
    return counter(ctx, "train.step", "h2d_bytes", 1e-6)
