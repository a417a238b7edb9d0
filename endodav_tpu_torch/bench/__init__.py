"""Measurements of the port's kernels on a CUDA card; nothing on the main
path imports this package."""
