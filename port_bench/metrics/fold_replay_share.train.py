"""``fold_replay_share.train``: the share of the traced run's unprofiled
epoch's ``train.step`` spans that hold a ``train.replay`` span, read from
the fold-parallel epoch (``train/cv_parallel.py``): the stacked steps of
all folds that the program replayed as one CUDA graph (1.0 where every
step was). It is ``graph_replay_share.train``'s reader, loaded through the
registry, so None where the run was not traced, where the epoch is not
there whole, and for a program that records no ``train.replay`` span (one
whose stacked step runs eagerly)."""

from port_bench.core import registry

read = registry.load_metric("graph_replay_share.train")
