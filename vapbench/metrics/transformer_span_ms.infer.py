"""Device ms of both GPTs inside a ``VapModel.probs`` call: the program's
``vap.gpt_channel`` and ``vap.gpt_cross`` spans under its ``vap.probs`` root,
mean a call of the traced stretch."""

from vapbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "vap.probs", ("vap.gpt_channel", "vap.gpt_cross"))
