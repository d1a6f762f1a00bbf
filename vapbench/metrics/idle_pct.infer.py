"""Device idle share of the traced stretch."""

from vapbench.readers import idle_pct as read  # noqa: F401
