"""The benchmark's own code: what every cell shares (the command line, the
device's description, the synthetic cohort and weights, the trace reader,
the peaks and the arithmetic of the kernels' bounds). Nothing here is
specific to one configuration, traffic mix or per-layer metric."""
