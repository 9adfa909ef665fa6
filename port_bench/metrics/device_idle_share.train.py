"""``device_idle_share.train``: the share of the traced epoch in which no
kernel and no copy ran on the device (the union of their intervals against
the epoch's span, which ends with a synchronize)."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
