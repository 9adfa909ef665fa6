"""The readers of the train step's CUDA-graph replay,
``graph_replay_share.train`` and ``capture_s.train``, on span records made
here (the CPU replays nothing): each one's value on a plain epoch, and None
for an untraced run, for a program without ``train.replay`` spans and for
an epoch made under a profiler."""

from types import SimpleNamespace

import pytest
import torch

import pbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from multimodal_survival_prediction_tpu_torch.utils import profiling
from multimodal_survival_prediction_tpu_torch.utils.profiling import span
from port_bench.core import registry

TRACED = object()  # a stand-in for a trace summary: the run was traced
STEPS = 4


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _read(name, steps=STEPS, summary=TRACED):
    return registry.load_metric(name)(SimpleNamespace(summary=summary,
                                                      steps=steps))


def _epoch(replayed: int, capture_at=None):
    """A ``train.epoch`` of ``STEPS`` steps, the last ``replayed`` of them
    replays, as the program records them; a ``setup.capture`` before step
    ``capture_at``."""
    with span("train.epoch"):
        for k in range(STEPS):
            if k == capture_at:
                with span("setup.capture"):
                    with span("train.step"):
                        with span("train.forward"):
                            pass
            with span("train.step"):
                if k >= STEPS - replayed:
                    with span("train.replay"):
                        pass
                else:
                    for phase in ("forward", "backward", "optimizer"):
                        with span(f"train.{phase}"):
                            pass
        with span("train.readback"):
            pass


def test_set_up_then_a_replayed_epoch():
    """Set-up as the cells make it (an eager first step, then the capture
    and its replay, then a replay), then an epoch of replays: a share of
    1.0 and the capture's span."""
    with span("setup.init_state"):
        pass
    _epoch(replayed=STEPS - 1, capture_at=1)
    _epoch(replayed=STEPS)
    assert _read("graph_replay_share.train") == 1.0
    (cap,) = [r for r in profiling.spans() if r.name == "setup.capture"]
    assert _read("capture_s.train") == (cap.end_ns - cap.start_ns) / 1e9 > 0


def test_the_share_counts_the_plain_epoch_s_replays():
    _epoch(replayed=STEPS)
    _epoch(replayed=STEPS - 1, capture_at=1)  # the last plain epoch
    assert _read("graph_replay_share.train") == (STEPS - 1) / STEPS
    assert _read("capture_s.train") is not None
    assert _read("graph_replay_share.train", steps=STEPS + 1) is None


def test_untraced_runs_give_none():
    _epoch(replayed=STEPS - 1, capture_at=1)
    for name in ("graph_replay_share.train", "capture_s.train"):
        assert _read(name, summary=None) is None


def test_a_program_that_does_not_replay_gives_none():
    """The parent's records: eager steps only, no capture."""
    _epoch(replayed=0)
    assert _read("graph_replay_share.train") is None
    assert _read("capture_s.train") is None


def test_profiled_epochs_give_none():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _epoch(replayed=STEPS - 1, capture_at=1)
    assert all(r.profiled for r in profiling.spans())
    assert _read("graph_replay_share.train") is None
    assert _read("capture_s.train") is None
