"""Tensor ops of the port: sampling, padding, correlation and its CUDA kernel."""
