"""A ``torch.profiler`` window read in memory (no trace file is written).

The window opens with one launch of ``torch.cuda._sleep`` and a
synchronize, because the card's profiler can lose a window's first launch
(the sentinel of ``chip_smoke.py:_profiled``), and the measured span is the
benchmark's own ``record_function`` named :data:`WINDOW`, which ends with a
synchronize. :class:`Summary` holds what the per-layer readers need: the
device's kernel and copy intervals inside the span, the benchmark's spans,
and the host's innermost op at any moment, to label the device's idle gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import numpy as np

WINDOW = "pbench.window"
SENTINEL_KERNEL = "spin_kernel"  # torch.cuda._sleep's
SPAN_PREFIX = "pbench."
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


class Summary:
    """Device and host events of one traced window.

    ``kernels``: ``(start_s, end_s, name)`` of each device kernel, ``copies``
    the same of each copy or fill, both relative to the window's start;
    ``spans``: the benchmark's spans ``(name, start_s, end_s)``;
    ``window_s``: the span's length."""

    def __init__(self, kernels, copies, spans, window_s, host_segments):
        self.kernels = kernels
        self.copies = copies
        self.spans = spans
        self.window_s = window_s
        self._seg_start = [s for s, _, _ in host_segments]
        self._segs = host_segments

    # -- device time --
    def busy_intervals(self) -> np.ndarray:
        """The union of the kernel and copy intervals, merged, clipped to
        the window: an (n, 2) array."""
        iv = sorted((max(s, 0.0), min(e, self.window_s))
                    for s, e, _ in self.kernels + self.copies
                    if e > 0 and s < self.window_s)
        merged: list = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return np.asarray(merged, np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float((b[:, 1] - b[:, 0]).sum()) if len(b) else 0.0

    def idle_gaps(self):
        """``(start_s, length_s)`` of every idle stretch in the window."""
        b = self.busy_intervals()
        edges = np.concatenate([[0.0], b.reshape(-1), [self.window_s]])
        starts, ends = edges[0::2], edges[1::2]
        keep = ends > starts
        return list(zip(starts[keep], (ends - starts)[keep]))

    def host_op_at(self, t: float) -> str:
        """The innermost host op running at ``t`` (window seconds), or
        ``python`` where none was."""
        i = bisect.bisect_right(self._seg_start, t) - 1
        if i >= 0:
            s, e, name = self._segs[i]
            if s <= t < e:
                return name
        return "python"

    def span(self, name: str):
        """The first span called ``name``, ``(start_s, end_s)``, or None."""
        for n, s, e in self.spans:
            if n == name:
                return s, e
        return None

    def kernels_in(self, start: float, end: float):
        return [k for k in self.kernels if start <= k[0] < end]

    # -- the breakdown the result line carries --
    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for s, e, name in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle: dict = {}
        for start, length in self.idle_gaps():
            label = self.host_op_at(start + length / 2)
            idle[label] = idle.get(label, 0.0) + length
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, float(v)] for n, v in ops],
                "idle_gaps": [[n, float(v)] for n, v in gaps]}


def _host_segments(cpu_events, t0_ns: int, t1_ns: int) -> list:
    """Host events as non-overlapping ``(start_s, end_s, innermost name)``
    segments of one timeline: each thread's nesting swept with a stack, and
    where threads overlap, the segment of the thread whose op started last
    wins (good enough to label an idle gap)."""
    by_thread: dict = {}
    for ev in cpu_events:
        by_thread.setdefault(ev[3], []).append(ev)
    segs = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack: list = []  # (end, name)
        cursor = None
        for s, e, name, _ in evs:
            while stack and stack[-1][0] <= s:
                end, top = stack.pop()
                if cursor is not None and end > cursor:
                    segs.append((cursor, end, top))
                cursor = end
            if stack and cursor is not None and s > cursor:
                segs.append((cursor, s, stack[-1][1]))
            stack.append((e, name))
            cursor = s
        while stack:
            end, top = stack.pop()
            if cursor is not None and end > cursor:
                segs.append((cursor, end, top))
            cursor = end
    segs.sort()
    out = []
    for s, e, name in segs:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        if out and s < out[-1][1]:
            # overlap between threads: the later segment takes the rest
            ps, pe, pn = out[-1]
            out[-1] = (ps, s, pn)
            if out[-1][1] <= out[-1][0]:
                out.pop()
        out.append((s, e, name))
    return [((s - t0_ns) / 1e9, (e - t0_ns) / 1e9, n) for s, e, n in out]


class Profiled(contextlib.AbstractContextManager):
    """``with Profiled() as p: ...`` profiles the block; inside it, the
    caller wraps the measured part in :func:`window`. After the block,
    ``p.summary`` is a :class:`Summary` and ``p.read_s`` the seconds that
    reading the events took."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.summary = None
        self.read_s = 0.0

    def __enter__(self):
        import torch

        self.prof.__enter__()
        torch.cuda._sleep(1 << 16)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            self.summary = summarize(self.prof.profiler.kineto_results)
            self.read_s = time.perf_counter() - t
        return False


def summarize(kineto_results) -> Summary:
    from torch.autograd import DeviceType

    kernels, copies, cpu, spans = [], [], [], []
    win = None
    for ev in kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the sentinel, and the device-side copies of the host's
            # annotations (the benchmark's spans), are not device work
            if SENTINEL_KERNEL in name or name.startswith(SPAN_PREFIX):
                continue
            rec = (ev.start_ns(), ev.end_ns(), name)
            (copies if name.startswith(COPY_PREFIXES) else kernels).append(rec)
        else:
            rec = (ev.start_ns(), ev.end_ns(), name, ev.start_thread_id())
            if name == WINDOW:
                win = rec
            elif name.startswith(SPAN_PREFIX):
                spans.append(rec)
            cpu.append(rec)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0, t1 = win[0], win[1]

    def rel(recs):
        return [((s - t0) / 1e9, (e - t0) / 1e9, n) for s, e, n in recs
                if e > t0 and s < t1]

    return Summary(rel(kernels), rel(copies),
                   [(n, (s - t0) / 1e9, (e - t0) / 1e9)
                    for s, e, n, _ in sorted(spans)],
                   (t1 - t0) / 1e9,
                   _host_segments([c for c in cpu if c[2] != WINDOW
                                   and c[1] > t0 and c[0] < t1], t0, t1))


@contextlib.contextmanager
def window():
    """The measured span of a traced run; ends with a synchronize."""
    import torch
    from torch.profiler import record_function

    with record_function(WINDOW):
        yield
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str):
    """One of the benchmark's own spans (``pbench.<name>``)."""
    from torch.profiler import record_function

    with record_function(SPAN_PREFIX + name):
        yield
