"""``readback_wait_ms.train``: the traced run's unprofiled epoch's
``train.readback``, the host waiting at the epoch's end for the device to
finish its steps and hand back the mean loss (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.readback_ms(run)
