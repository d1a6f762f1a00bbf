"""Parallelism of the port: context parallelism over a device mesh."""
