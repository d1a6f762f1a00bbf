"""Host ms of ``BatchedKVStreamer.push`` a tick, from the call to its return
with the outputs still in flight: the program's ``kv.push`` root, mean a
tick of the traced stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "kv.push", ("kv.push",), clock="host")
