"""Checkpoint and results I/O of the port and the weight carry-over from
JAX."""
