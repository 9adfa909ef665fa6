"""The program's own spans, as the per-layer readers read them.

The port records a span at each of its phases (``utils/profiling.py``:
``span``, ``spans()``), always on, on the host clock. A traced run carries
two training epochs: one without a profiler (the one ``step_mfu.train``
times) and then the profiled one. The readers of the step's phases read
the first: a span opened under a profiler reads a host the timed runs do
not have. The set-up readers read the process's first spans, which set-up
made before any profiler.

The readers (``metrics/<name>.py``):

- ``forward_host_ms.train``, ``backward_host_ms.train``,
  ``optimizer_host_ms.train``: the mean self time a step of
  ``train.forward``, ``train.backward``, ``train.optimizer``;
- ``readback_wait_ms.train``: the epoch's ``train.readback``;
- ``first_step_s.train``: the process's first ``train.step``, whole;
- ``kernel_load_s.train``: the sum of the ``setup.kernel_library`` spans;
- ``init_state_s.train``: the process's first ``setup.init_state``.

Every reader returns None where the run was not traced, where the program
records no spans (a program older than them), or where what it reads is
not there whole; it never raises for that. Self time is computed here,
not taken from the program.
"""

from __future__ import annotations


def records(run):
    """The program's span records, or None: for an untraced run, for a
    program without spans, or where the ring has dropped the process's
    first records."""
    if run.summary is None:
        return None
    try:
        from multimodal_survival_prediction_tpu_torch.utils.profiling import (
            spans,
        )
    except ImportError:
        return None
    recs = spans()
    if not recs or recs[0].index != 0:
        return None
    return recs


def _children(recs) -> dict:
    kids: dict = {}
    for r in recs:
        if r.parent is not None and r.end_ns is not None:
            kids.setdefault(r.parent, []).append(r)
    return kids


def _self_ns(rec, kids: dict) -> int:
    covered = sum(min(c.end_ns, rec.end_ns) - max(c.start_ns, rec.start_ns)
                  for c in kids.get(rec.index, ()))
    return rec.end_ns - rec.start_ns - covered


def plain_epoch(run):
    """``(epoch, steps, kids)`` of the last ``train.epoch`` opened with no
    profiler recording whose ``train.step`` children number ``run.steps``,
    or None."""
    recs = records(run)
    if recs is None or run.steps <= 0:
        return None
    kids = _children(recs)
    for rec in reversed(recs):
        if (rec.name != "train.epoch" or rec.profiled
                or rec.end_ns is None):
            continue
        steps = [c for c in kids.get(rec.index, ()) if c.name == "train.step"]
        if len(steps) == run.steps:
            return rec, steps, kids
    return None


def step_phase_ms(run, name: str):
    """The mean self time a step of the plain epoch's ``name`` spans (one
    a step), in ms."""
    found = plain_epoch(run)
    if found is None:
        return None
    _, steps, kids = found
    phases = [c for s in steps for c in kids.get(s.index, ())
              if c.name == name]
    if len(phases) != len(steps):
        return None
    return sum(_self_ns(p, kids) for p in phases) / len(steps) / 1e6


def readback_ms(run):
    """The plain epoch's ``train.readback``, in ms."""
    found = plain_epoch(run)
    if found is None:
        return None
    epoch, _, kids = found
    backs = [c for c in kids.get(epoch.index, ())
             if c.name == "train.readback"]
    if len(backs) != 1:
        return None
    return (backs[0].end_ns - backs[0].start_ns) / 1e6


def _closed(run, name: str):
    recs = records(run)
    if recs is None:
        return None
    return [r for r in recs if r.name == name and r.end_ns is not None]


def first_s(run, name: str):
    """The process's first ``name`` span, in s, or None (none, or opened
    under a profiler)."""
    found = _closed(run, name)
    if not found or found[0].profiled:
        return None
    return (found[0].end_ns - found[0].start_ns) / 1e9


def total_s(run, name: str):
    """The sum of the process's ``name`` spans, in s (0 where there are
    none), or None (one of them opened under a profiler)."""
    found = _closed(run, name)
    if found is None or any(r.profiled for r in found):
        return None
    return sum(r.end_ns - r.start_ns for r in found) / 1e9
