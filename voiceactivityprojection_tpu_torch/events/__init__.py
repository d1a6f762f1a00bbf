"""Turn-taking events and their metrics, on the host (JAX: events/)."""
