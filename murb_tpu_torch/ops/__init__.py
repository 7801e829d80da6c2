"""Sweeps, the proxy solver, order validation and the CUDA kernel wrappers."""
