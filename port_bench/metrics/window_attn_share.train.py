"""``window_attn_share.train``: the window attention's kernels (forward
and backward, matched by ``core/window_attn.py``) over the device's busy
time inside the traced epoch's ``train_epoch`` span, in %. None where no
attention kernel ran there."""

from port_bench.core import window_attn


def read(run):
    s = run.summary
    if s is None:
        return None
    span = s.span("pbench.train_epoch")
    if span is None:
        return None
    return window_attn.attn_share(s, *span)
