"""Analysis tools over the port: the phrases directionality analysis and its
figure, projection-label frequencies, weight / activation / gradient
statistics and the stereo browsers' PNG exports (JAX: the root ``analyzes/``)."""
