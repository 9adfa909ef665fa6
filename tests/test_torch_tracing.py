"""The port's spans (``utils/profiling.py``): the records a span leaves,
their nesting, self time, per-thread stacks and the ring's bound; the
``profiled`` flag; the spans of a ``Trainer`` epoch (device-resident and
streaming), of ``init_state`` and of the kernel-build cache; the spans as
ranges of ``profile_trace``'s Chrome trace and never of another profiler;
and a loose bound on a span's cost. CPU only."""

import json
import threading
import time

import _ctypes
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_survival_prediction_tpu_torch.io import aot_cache
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.utils import profiling
from multimodal_survival_prediction_tpu_torch.utils.profiling import span

TRAIN_SPANS = ("train.epoch", "train.step", "train.forward",
               "train.backward", "train.optimizer", "train.readback")
STEP_PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _by_name(records, name):
    return [r for r in records if r.name == name]


def _children(records, parent):
    return [r for r in records if r.parent == parent.index]


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------

def test_records_order_nesting_and_self_time():
    with span("a"):
        with span("b"):
            time.sleep(0.002)
        with span("c"):
            with span("d"):
                time.sleep(0.002)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["a", "b", "c", "d"]
    assert [r.index for r in recs] == [0, 1, 2, 3]
    a, b, c, d = recs
    assert (a.parent, b.parent, c.parent, d.parent) == (None, 0, 0, 2)
    for child in (b, c, d):
        parent = recs[child.parent]
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    assert not any(r.profiled for r in recs)
    assert profiling.self_ns(b, recs) == b.duration_ns
    assert profiling.self_ns(c, recs) == c.duration_ns - d.duration_ns
    assert profiling.self_ns(a, recs) == (a.duration_ns - b.duration_ns
                                          - c.duration_ns)
    assert 0 <= profiling.self_ns(a, recs) < a.duration_ns


def test_an_open_span_has_no_end_yet():
    with span("open"):
        (rec,) = profiling.spans()
        assert rec.end_ns is None and rec.start_ns is not None
    (rec,) = profiling.spans()
    assert rec.end_ns >= rec.start_ns


def test_each_thread_has_its_own_stack():
    """A span opened on another thread while the main thread holds one
    open has no parent; the main thread's next span nests in its own."""
    seen = threading.Event()

    def worker():
        with span("worker.outer"):
            with span("worker.inner"):
                pass
        seen.set()

    with span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and seen.is_set()
        with span("main.inner"):
            pass
    recs = {r.name: r for r in profiling.spans()}
    assert recs["worker.outer"].parent is None
    assert recs["worker.inner"].parent == recs["worker.outer"].index
    assert recs["main.inner"].parent == recs["main.outer"].index


def test_the_ring_keeps_the_newest_records():
    extra = 10
    for _ in range(profiling.RING_SIZE + extra):
        with span("x"):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.RING_SIZE >= 16384
    assert recs[0].index == extra
    assert recs[-1].index == profiling.RING_SIZE + extra - 1


@pytest.mark.parametrize("under_profiler", [False, True])
def test_profiled_flag(under_profiler):
    if under_profiler:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("s"):
                pass
    else:
        with span("s"):
            pass
    (rec,) = profiling.spans()
    assert rec.profiled is under_profiler


def test_a_span_is_cheap():
    """A loose guard (the cost on the card's host is measured there):
    10,000 spans without a profiler in well under half a second."""
    t = time.perf_counter()
    for _ in range(10_000):
        with span("cost"):
            pass
    assert time.perf_counter() - t < 0.5
    assert len(profiling.spans()) == 10_000


# ---------------------------------------------------------------------------
# the Trainer's spans
# ---------------------------------------------------------------------------

class _Hazard(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.lin = nn.Linear(4, 1)
        with torch.no_grad():
            self.lin.weight.copy_(torch.randn(1, 4, generator=generator))

    def forward(self, x):
        return self.lin(x)[:, 0]


def _trainer(batch_size=4):
    cfg = engine.TrainConfig(batch_size=batch_size, eval_batch_size=8,
                             learning_rate=1e-2)
    return engine.Trainer(_Hazard, lambda b: (b["x"],), cfg=cfg,
                          device="cpu")


def _cohort(n=14, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 4)).astype(np.float32),
            "time": rng.uniform(1, 10, n).astype(np.float32),
            "event": (rng.uniform(size=n) < 0.6).astype(np.float32),
            "svalid": np.ones(n, np.float32)}


def _epoch(trainer, state, streaming, host):
    rng = np.random.default_rng(1)
    indices = np.arange(len(host["x"]))
    if streaming:
        return trainer.train_epoch_streaming(state, host, indices, rng,
                                             1e-2)
    data = {k: torch.from_numpy(v) for k, v in host.items()}
    return trainer.train_epoch(state, data, indices, rng, 1e-2)


def test_init_state_is_one_span():
    _trainer().init_state(fold=0)
    (rec,) = profiling.spans()
    assert (rec.name, rec.parent, rec.profiled) == ("setup.init_state",
                                                    None, False)
    assert rec.end_ns > rec.start_ns


@pytest.mark.parametrize("streaming", [False, True])
def test_epoch_spans(streaming):
    trainer, host = _trainer(), _cohort()
    state = trainer.init_state(fold=0)
    profiling.reset_spans()
    _epoch(trainer, state, streaming, host)
    recs = profiling.spans()
    steps = -(-len(host["x"]) // trainer.cfg.batch_size)
    (epoch,) = _by_name(recs, "train.epoch")
    assert epoch.parent is None
    kids = _children(recs, epoch)
    assert [r.name for r in kids] == ["train.step"] * steps + [
        "train.readback"]
    for step in kids[:-1]:
        assert [r.name for r in _children(recs, step)] == list(STEP_PHASES)
    assert {r.name for r in recs} == set(TRAIN_SPANS)
    assert len(recs) == 2 + 4 * steps
    by_index = {r.index: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns and not r.profiled
        if r.parent is not None:
            p = by_index[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for step in kids[:-1]:
        assert 0 <= profiling.self_ns(step, recs) <= step.duration_ns


def test_profile_trace_holds_the_spans(tmp_path):
    trainer, host = _trainer(), _cohort()
    state = trainer.init_state(fold=0)
    with profiling.profile_trace(tmp_path / "prof"):
        _epoch(trainer, state, False, host)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    steps = -(-len(host["x"]) // trainer.cfg.batch_size)
    for name in TRAIN_SPANS:
        want = steps if name in STEP_PHASES + ("train.step",) else 1
        assert names.count(name) == want, name
    assert all(r.profiled for r in profiling.spans()
               if r.name.startswith("train."))


def test_another_profiler_gets_no_span_event():
    """Under a profiler the program did not open, the spans record
    ``profiled`` and add no event: that profiler's device time and names
    are its own ops' alone."""
    trainer, host = _trainer(), _cohort()
    state = trainer.init_state(fold=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _epoch(trainer, state, False, host)
    names = {e.name for e in prof.events()}
    names |= {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::addmm" in names or "aten::linear" in names
    recorded = {r.name for r in profiling.spans()}
    assert recorded >= set(TRAIN_SPANS)
    assert not names & recorded
    assert all(r.profiled for r in profiling.spans()
               if r.name.startswith("train."))


# ---------------------------------------------------------------------------
# the kernel-build cache
# ---------------------------------------------------------------------------

def test_each_library_load_is_one_span_inside_the_caller(tmp_path):
    """A build and then a hit, each one ``setup.kernel_library`` span
    nested in the span open around it (a library that loads lazily in a
    step's forward sits inside that forward)."""
    library = open(_ctypes.__file__, "rb").read()

    def compile_(out, entry_dir):
        out.write_bytes(library)
        return {}

    for built in (True, False):
        profiling.reset_spans()
        with span("train.forward"):
            _, info = aot_cache.load_or_build(
                "probe", b"source", {"name": "probe"}, compile_, tmp_path,
                tmp_path)
        assert info["built"] is built
        outer, load = profiling.spans()
        assert (load.name, load.parent) == ("setup.kernel_library",
                                            outer.index)
        assert outer.start_ns <= load.start_ns <= load.end_ns \
            <= outer.end_ns
