"""Device ms of the transformer's KV layer steps a tick (every layer's
attention rows over the rings, LayerNorms and FFN): the program's
``kv.layer`` spans under its ``kv.push`` root, mean a tick of the traced
stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "kv.push", ("kv.layer",))
