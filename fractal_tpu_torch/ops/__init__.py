"""Tensor ops, kernels and their plain versions."""
