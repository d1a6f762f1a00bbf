"""MB the program copies from host memory to the card a tick: its
``h2d_bytes`` counter under the ``kv.push`` root (the hop's audio of every
dialog), mean a tick of the traced stretch."""

from vapbench.program_spans import counter


def read(ctx):
    return counter(ctx, "kv.push", "h2d_bytes", 1e-6)
