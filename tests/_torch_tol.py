"""The bfloat16 bar of the port's tests, shared by their files."""

import math


def bf16_tol(want, steps=2):
    """``steps`` bf16 roundings at the largest magnitude of ``want`` (a numpy
    array or a tensor): a kernel and its plain version sum in f32 in other
    orders, then round the same way, so a sum that lands across a rounding
    boundary moves an output by one step."""
    top = max(float(abs(want).max()), 1.0)
    return steps * 2.0 ** (math.floor(math.log2(top)) - 7)
