"""Numerical ops of the port: the CT resample (with its CUDA kernel) and the
loss terms. Kernel sources live in ``csrc/`` and build on first use."""
