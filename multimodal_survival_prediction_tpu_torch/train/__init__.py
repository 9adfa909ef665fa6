"""Training (the Trainer, the K-fold CV driver and its CLI) and scoring of
the port."""
