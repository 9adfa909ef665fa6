"""The reader of the fold-parallel step's CUDA-graph replay,
``fold_replay_share.train``, on span records made here as the stacked
epoch makes them (the CPU replays nothing): 1.0 from a plain epoch whose
steps all replayed, the share of a mixed one, and None without spans, for
the parent's eager stacked epoch, for an untraced run and for an epoch made
under a profiler."""

from types import SimpleNamespace

import pytest
import torch

import pbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from multimodal_survival_prediction_tpu_torch.utils import profiling
from multimodal_survival_prediction_tpu_torch.utils.profiling import span
from port_bench.core import registry

TRACED = object()  # a stand-in for a trace summary: the run was traced
STEPS = 5
NAME = "fold_replay_share.train"


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _read(steps=STEPS, summary=TRACED):
    return registry.load_metric(NAME)(SimpleNamespace(summary=summary,
                                                      steps=steps))


def _epoch(eager=(), capture_at=None, spans=True):
    """A stacked epoch of ``STEPS`` steps: those in ``eager`` run the eager
    body (a warm-up or a masked step), the others replay; the capture
    before step ``capture_at``. ``spans=False``: a program whose stacked
    epoch records none."""
    if not spans:
        return
    with span("train.epoch"):
        for k in range(STEPS):
            with span("train.step"):
                if k == capture_at:
                    with span("setup.capture"):
                        pass
                if k not in eager:
                    with span("train.replay"):
                        pass


def test_set_up_then_a_replayed_epoch_reads_one():
    """Set-up's three one-step epochs (warm-up, capture and its replay,
    a replay), then an epoch of replays."""
    with span("setup.init_state"):
        pass
    for k in range(3):
        with span("train.epoch"):
            with span("train.step"):
                if k == 1:
                    with span("setup.capture"):
                        pass
                if k:
                    with span("train.replay"):
                        pass
    _epoch()
    assert _read() == 1.0
    assert _read(steps=1) == 1.0  # set-up's last one-step epoch


def test_a_mixed_epoch_reads_its_share():
    """The masked tail step of unequal folds runs eagerly."""
    _epoch()
    _epoch(eager={STEPS - 1})
    assert _read() == (STEPS - 1) / STEPS
    _epoch(eager={0}, capture_at=1)
    assert _read() == (STEPS - 1) / STEPS
    assert _read(steps=STEPS + 1) is None


@pytest.mark.parametrize("case", ["no_spans", "eager_program", "untraced",
                                  "profiled"])
def test_nothing_to_read_gives_none(case):
    if case == "no_spans":
        assert _read() is None
        return
    if case == "eager_program":
        with span("setup.init_state"):
            pass
        _epoch(spans=False)
        _epoch(eager=set(range(STEPS)))
        assert _read() is None
        return
    if case == "untraced":
        _epoch()
        assert _read(summary=None) is None
        return
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _epoch()
    assert all(r.profiled for r in profiling.spans())
    assert _read() is None
