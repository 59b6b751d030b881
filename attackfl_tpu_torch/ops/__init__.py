"""Tensor programs over stacked client parameters, and the CUDA kernel."""
