"""Profiling and the port's spans (port of
``multimodal_survival_prediction_tpu/utils/profiling.py``).

``profile_trace`` is a ``torch.profiler`` window (CPU, and CUDA where there
is a card) that writes a Chrome trace into its directory, the counterpart of
JAX's ``jax.profiler`` trace.

``span(name)`` times one phase of the program on the host clock. Recording
is always on: each span appends one record to a bounded in-memory ring
(:data:`RING_SIZE` records; the oldest go first; read as
:class:`SpanRecord`), with its
start and end in ``time.perf_counter_ns()``, the index of the span it
opened inside on the same thread, and whether a ``torch.profiler`` was
recording when it opened. Outside ``profile_trace`` that is all a span
does (two clock reads, a flag read and an append); inside it, each span
also opens ``torch.profiler.record_function(name)``, so the trace shows
the program's phases on the kernels' clock. A profiler that the program
did not open gets no event from a span.

The spans and where they are opened:

==========================  ==============================================
``train.epoch``             ``Trainer.train_epoch`` and
                            ``Trainer._train_batches``: a whole epoch;
                            ``train/cv_parallel.py``'s stacked epoch
``train.step``              ``Trainer.train_step``, or a replay: one
                            optimizer step; ``train/cv_parallel.py``'s
                            stacked step of all folds, or its replay
``train.forward``           ``Trainer.loss_and_grads``: model and loss
``train.backward``          ``Trainer.loss_and_grads``: autograd's
                            backward and the mesh's all-reduce
``train.optimizer``         ``Trainer.train_step``: clip, Adam and the
                            parameter update
``train.replay``            ``train/graphs.py:CapturedStep``: a step of
                            ``train_epoch`` or of the stacked epoch
                            replayed as a CUDA graph (its input copies,
                            the replay, the loss copy), inside its
                            ``train.step``
``train.readback``          ``Trainer._readback``: the epoch's mean loss
                            read back to the host
``setup.capture``           ``CapturedStep``: the capture of a step's
                            CUDA graph (around the captured body's
                            ``train.step``)
``setup.init_state``        ``Trainer.init_state``: model build, copy to
                            the device, dropout generator, moments
``setup.kernel_library``    ``io/aot_cache.py:load_or_build``: key, load
                            or build and ``dlopen`` of one library
``swin.patch_embed``        ``models/swin3d.py:SwinTransformer``: the
                            Swin-ViT encoder's patch embedding, in every
                            eager forward (a replay records none)
``swin.stage1`` .. ``4``    the same encoder's stages: blocks and merging
==========================  ==============================================

``spans()`` returns the records, ``self_ns`` a span's self time and
``reset_spans()`` empties the ring.

``count(name, n)`` adds ``n`` to a counter, beside the spans and as cheap
(a dict update on the host, no device work, so it may run inside a CUDA
graph's capture, where it counts the captured call once). ``counters()``
reads them all and ``reset_counters()`` sets them to 0. The counters:

==================================  ======================================
``swin.window_tokens.real``         ``models/swin3d.py``: each window
                                    attention call's tokens before padding
                                    (batch x D x H x W of its stage)
``swin.window_tokens.attended``     the same call's tokens after padding to
                                    whole windows, the padding included
==================================  ======================================
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from time import perf_counter_ns
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 16384

_RING: collections.deque = collections.deque(maxlen=RING_SIZE)
_INDEX = itertools.count()
_STACKS = threading.local()  # each thread's open spans, innermost last
_ANNOTATE = [0]  # the depth of open profile_trace windows
_COUNTS: collections.Counter = collections.Counter()


class SpanRecord(NamedTuple):
    """One span: ``index`` (in opening order, from 0 in the process or
    since :func:`reset_spans`), ``name``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns()``; ``end_ns`` is None while it is open),
    ``parent`` (the index of the span it opened inside on its thread, or
    None) and ``profiled`` (a ``torch.profiler`` was recording when it
    opened)."""

    index: int
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    profiled: bool

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class span:
    """``with span("train.step"): ...`` records the block (module
    docstring). A class, not a generator context manager, and its record a
    plain list until :func:`spans` reads it: it sits on the training
    step's path."""

    __slots__ = ("name", "_rec", "_stack", "_annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _STACKS.stack
        except AttributeError:
            stack = _STACKS.stack = []
        profiled = _autograd_profiler._is_profiler_enabled
        # [index, name, start_ns, end_ns, parent, profiled]: SpanRecord's
        rec = [next(_INDEX), self.name, None, None,
               stack[-1][0] if stack else None, profiled]
        stack.append(rec)
        self._rec, self._stack = rec, stack
        if profiled and _ANNOTATE[0]:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        else:
            self._annotation = None
        _RING.append(rec)
        rec[2] = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        self._rec[3] = end
        self._stack.pop()
        return False


def spans() -> list:
    """The records in the ring, in opening order, as :class:`SpanRecord`
    (a snapshot: a span still open keeps ``end_ns`` None)."""
    return [SpanRecord(*rec) for rec in list(_RING)]


def reset_spans():
    """Empty the ring and number the next span 0 (for tests)."""
    global _INDEX
    _RING.clear()
    _INDEX = itertools.count()


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` (module docstring)."""
    _COUNTS[name] += n


def counters() -> dict:
    """``{name: total}`` of every counter so far (a snapshot)."""
    return dict(_COUNTS)


def reset_counters():
    """Set every counter to 0 (drop them all)."""
    _COUNTS.clear()


def self_ns(rec: SpanRecord, records) -> int:
    """``rec``'s duration less the part of it that its closed child spans
    (those of ``records`` whose ``parent`` is ``rec.index``) cover. A
    thread's children of one span never overlap: it opened them one after
    another."""
    covered = sum(min(c.end_ns, rec.end_ns) - max(c.start_ns, rec.start_ns)
                  for c in records
                  if c.parent == rec.index and c.end_ns is not None)
    return rec.duration_ns - covered


@contextlib.contextmanager
def profile_trace(log_dir):
    """Trace a code block with ``torch.profiler`` and write the trace as
    ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format;
    TensorBoard's profiler plugin and Perfetto open it). Inside it, each
    :class:`span` is also a ``record_function`` range of the trace. Usage:

        with profile_trace("/tmp/trace"):
            run_epoch(...)
    """
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        _ANNOTATE[0] += 1
        try:
            yield
        finally:
            _ANNOTATE[0] -= 1
