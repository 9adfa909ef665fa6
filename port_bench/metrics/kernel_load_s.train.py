"""``kernel_load_s.train``: the sum of the process's
``setup.kernel_library`` spans: key, load or build and ``dlopen`` of each
kernel library; 0 where the model loads none (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.total_s(run, "setup.kernel_library")
