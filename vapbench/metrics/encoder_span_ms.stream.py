"""Device ms of the exact streaming encoder a tick: the program's
``kv.encoder`` span under its ``kv.push`` root, mean a tick of the traced
stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "kv.push", ("kv.encoder",))
