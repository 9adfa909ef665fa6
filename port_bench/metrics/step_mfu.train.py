"""``step_mfu.train``: one whole epoch's share of the card's float32 peak.

The FLOPs are the reference model's (``core/flops.py``, frozen per patient
in the configuration file) for every train step of the epoch (padded batch
rows included, since the device computes them) and every eval forward;
the time is the host clock over that epoch (train, evaluate, schedule and
best-weights copy), the one the traced run makes before its profiled
epoch, since the profiler slows the host; the peak is NVIDIA's float32
rate outside the tensor cores (``core/peaks.py``)."""

from port_bench.core import peaks


def read(run):
    if not run.plain_epoch_s:
        return None
    return (100.0 * run.epoch_flops / run.plain_epoch_s
            / peaks.H100_F32_OPS_PER_S)
