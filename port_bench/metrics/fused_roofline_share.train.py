"""``fused_roofline_share.train``: the fused BN -> ReLU -> 1x1-conv
kernels' share of their roofline over the traced epoch's train steps.

The stages come from the configuration (every dense layer's first stage
and each transition, at the cell's batch), each charged its four calls at
``fused_bound_ms``; the device time is that of the kernels the four
wrappers launch and of their fold kernel, inside the ``train_epoch`` span.
Nothing to read (None) where no fused kernel ran."""

from port_bench.core import peaks


def read(run):
    s = run.summary
    if s is None or not run.fused_stages:
        return None
    span = s.span("pbench.train_epoch")
    if span is None:
        return None
    device_s = sum(e - b for b, e, name in s.kernels_in(*span)
                   if peaks.is_fused_kernel(name))
    if device_s <= 0:
        return None
    bound_s = peaks.fused_step_bound_ms(run.fused_stages) / 1e3 * run.steps
    return 100.0 * bound_s / device_s
