"""Device ms of the heads and the probabilities inside a ``VapModel.probs``
call: the program's ``vap.heads`` and ``vap.probs_from_logits`` spans under
its ``vap.probs`` root, mean a call of the traced stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "vap.probs", ("vap.heads", "vap.probs_from_logits"))
