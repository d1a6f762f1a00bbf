"""Device kernels a call, step or tick, counted by the profiler."""

from vapbench.readers import launches_per_call as read  # noqa: F401
