"""``window_pad_share.train``: the window attention's padded tokens over
its attended tokens, in %, from the port's counters
(``utils/profiling.py:counters``, ``core/window_attn.py``) over every
eager forward of the traced run (set-up, capture and every evaluate). The
shares of a shape are fixed, so the mix of calls barely moves it. None
for a program without the counters."""

from port_bench.core import window_attn


def read(run):
    if run.summary is None:
        return None
    return window_attn.pad_share()
