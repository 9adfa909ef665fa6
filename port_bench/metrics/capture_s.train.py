"""``capture_s.train``: the process's first ``setup.capture`` span, the
capture of the train step's CUDA graph in set-up (its second step); None
where the program captures none (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.first_s(run, "setup.capture")
