"""Profiling and throughput instrumentation (port of
``multimodal_survival_prediction_tpu/utils/profiling.py``).

``profile_trace`` is a ``torch.profiler`` window (CPU, and CUDA where there
is a card) that writes a Chrome trace into its directory, the counterpart of
JAX's ``jax.profiler`` trace; ``block_and_time`` waits for the device with
``torch.cuda.synchronize``; ``ThroughputMeter`` is the JAX class unchanged.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def profile_trace(log_dir):
    """Trace a code block with ``torch.profiler`` and write the trace as
    ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format;
    TensorBoard's profiler plugin and Perfetto open it). Usage:

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
        yield


def _sync(result):
    """Wait until the card has run everything queued before it (a CPU
    result is ready as it is returned)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return result


def block_and_time(fn, *args, iters: int = 1, **kwargs):
    """(mean_seconds, last_result) with device completion included."""
    result = _sync(fn(*args, **kwargs))  # warmup (cuDNN's first calls)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _sync(result)
    return (time.perf_counter() - t0) / iters, result


@dataclass
class ThroughputMeter:
    """Steps/sec + items/sec counter for training loops."""

    name: str = "train"
    _t0: float = field(default_factory=time.perf_counter)
    steps: int = 0
    items: int = 0

    def update(self, n_items: int = 0):
        self.steps += 1
        self.items += n_items

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def items_per_sec(self) -> float:
        return self.items / max(self.elapsed, 1e-9)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "steps": self.steps,
            "items": self.items,
            "elapsed_sec": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "items_per_sec": round(self.items_per_sec, 3),
        }

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.items = 0
