"""Whole-call share of the card's roofline (see ``readers.mfu_pct``)."""

from vapbench.readers import mfu_pct as read  # noqa: F401
