"""``backward_host_ms.train``: the host's mean self time a train step in
``train.backward`` (autograd's dispatch of the backward and the mesh's
all-reduce), over the traced run's unprofiled epoch
(``core/spans.py``)."""

from port_bench.core import spans


def read(run):
    return spans.step_phase_ms(run, "train.backward")
