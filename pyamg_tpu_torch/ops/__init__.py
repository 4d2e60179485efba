"""Compute over the port's sparse containers: host (numpy/scipy) setup
ops, solve-phase products, and the CUDA kernels of ``dia_kernels``."""
