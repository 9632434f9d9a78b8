"""Kernels and matrix helpers of the port."""
