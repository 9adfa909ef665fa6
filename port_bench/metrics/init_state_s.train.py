"""``init_state_s.train``: the process's first ``setup.init_state``: the
model built with its random CPU init, moved to the card, its dropout
generator and the optimizer's moments (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.first_s(run, "setup.init_state")
