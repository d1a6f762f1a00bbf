"""Median tick of the window, from the push to its outputs on the host."""

from vapbench.readers import call_p50_ms as read  # noqa: F401
