"""Tensor operations of the port and the wrappers of its CUDA kernels."""
