"""The data pipeline: sliding windows over a session manifest and the batch loader (JAX: data/)."""
