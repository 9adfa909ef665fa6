"""``optimizer_host_ms.train``: the host's mean self time a train step in
``train.optimizer`` (the clip, Adam or AdamW and the parameter update),
over the traced run's unprofiled epoch (``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.step_phase_ms(run, "train.optimizer")
