"""``forward_host_ms.train``: the host's mean self time a train step in
``train.forward`` (the model, the mesh's gather and the Cox loss, as the
host dispatches them), over the traced run's unprofiled epoch
(``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.step_phase_ms(run, "train.forward")
