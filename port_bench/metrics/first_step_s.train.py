"""``first_step_s.train``: the process's first ``train.step``, whole: the
first set-up step, with the kernel libraries it loads on first use and
cuDNN's first calls (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.first_s(run, "train.step")
