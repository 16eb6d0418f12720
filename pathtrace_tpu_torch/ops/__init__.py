"""Kernels and their host wrappers."""
