"""The readers of the program's spans (``core/spans.py``, the seven
``metrics/*.py`` that read it) on the tiny cell, on the CPU: set-up and
one epoch through ``drivers/train_epochs.py:prepare``, then each reader
on a stand-in run. A finite number from each, None for an epoch of
another step count, for epochs made under a profiler, for an untraced run,
and for a program that records no spans."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pbench_tiny
from multimodal_survival_prediction_tpu_torch.utils import profiling
from port_bench.core import registry

EPOCH_READERS = ("forward_host_ms.train", "backward_host_ms.train",
                 "optimizer_host_ms.train", "readback_wait_ms.train")
SETUP_READERS = ("first_step_s.train", "kernel_load_s.train",
                 "init_state_s.train")
READERS = EPOCH_READERS + SETUP_READERS
TRACED = object()  # a stand-in for a trace summary: the run was traced


@pytest.fixture(scope="module")
def cell_run():
    """The tiny flagship cell's set-up and one plain epoch, with the
    process's spans from its start (the ring emptied first)."""
    cell = pbench_tiny.TinyCell("pm_train_b8", "partial_modality-dn121-f32",
                                "epochs_b8")
    drv = registry.load_driver("train_epochs")
    profiling.reset_spans()
    prep = drv.prepare(cell.config, cell.traffic, 2 ** 33 + 7,
                       torch.device("cpu"))
    b = int(cell.traffic["batch_size"])

    def epoch():
        prep.trainer.train_epoch(prep.state, prep.inputs.data,
                                 prep.train_rows, prep.shuffle, 1e-4)

    epoch()
    steps = -(-len(prep.train_rows) // b)
    yield prep, epoch, steps
    profiling.reset_spans()


def _read(name, run):
    return registry.load_metric(name)(run)


def test_every_reader_reads_a_finite_number(cell_run):
    _, _, steps = cell_run
    run = SimpleNamespace(summary=TRACED, steps=steps)
    got = {m: _read(m, run) for m in READERS}
    assert all(v is not None and math.isfinite(v) and v >= 0
               for v in got.values()), got
    assert got["kernel_load_s.train"] == 0.0  # no library loads on the CPU
    # the first step (three set-up steps came before the epoch's) and the
    # model's build are the process's first spans of their names
    recs = profiling.spans()
    first = next(r for r in recs if r.name == "train.step")
    assert got["first_step_s.train"] == (first.end_ns - first.start_ns) / 1e9
    assert recs[0].name == "setup.init_state"


def test_phase_readers_are_mean_self_times(cell_run):
    """forward + backward + optimizer: each step's time less its own
    self time, averaged over the epoch's steps."""
    _, _, steps = cell_run
    run = SimpleNamespace(summary=TRACED, steps=steps)
    recs = profiling.spans()
    (epoch,) = [r for r in recs if r.name == "train.epoch"
                and sum(c.parent == r.index and c.name == "train.step"
                        for c in recs) == steps]
    step_recs = [r for r in recs if r.parent == epoch.index
                 and r.name == "train.step"]
    want = np.mean([profiling.self_ns(s, recs) for s in step_recs]) / 1e6
    step_ms = np.mean([s.duration_ns for s in step_recs]) / 1e6
    phases = sum(_read(m, run) for m in EPOCH_READERS[:3])
    assert phases == pytest.approx(step_ms - want, rel=1e-9)


def test_an_epoch_of_another_step_count_gives_none(cell_run):
    _, _, steps = cell_run
    run = SimpleNamespace(summary=TRACED, steps=steps + 1)
    assert all(_read(m, run) is None for m in EPOCH_READERS)


def test_untraced_runs_and_programs_without_spans_give_none(cell_run,
                                                            monkeypatch):
    _, _, steps = cell_run
    untraced = SimpleNamespace(summary=None, steps=steps)
    assert all(_read(m, untraced) is None for m in READERS)
    monkeypatch.delattr(profiling, "spans")  # a program older than spans
    run = SimpleNamespace(summary=TRACED, steps=steps)
    assert all(_read(m, run) is None for m in READERS)


def test_spans_under_a_profiler_are_skipped(cell_run):
    """A profiled epoch after the plain one leaves every epoch reader on
    the plain one; with only profiled epochs there is nothing to read."""
    _, epoch, steps = cell_run
    run = SimpleNamespace(summary=TRACED, steps=steps)
    before = {m: _read(m, run) for m in EPOCH_READERS}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        epoch()
    assert {m: _read(m, run) for m in EPOCH_READERS} == before
    recs = profiling.spans()
    assert any(r.profiled for r in recs if r.name == "train.epoch")

    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("setup.kernel_library"):
            pass
        epoch()
    assert all(_read(m, run) is None for m in EPOCH_READERS)
    assert _read("kernel_load_s.train", run) is None
    assert _read("first_step_s.train", run) is None


def test_kernel_load_sums_every_library():
    profiling.reset_spans()
    try:
        for _ in range(3):
            with profiling.span("setup.kernel_library"):
                pass
        recs = profiling.spans()
        want = sum(r.end_ns - r.start_ns for r in recs) / 1e9
        run = SimpleNamespace(summary=TRACED, steps=1)
        assert _read("kernel_load_s.train", run) == want > 0
        assert _read("init_state_s.train", run) is None
    finally:
        profiling.reset_spans()
