"""Streaming epochs on the CPU: ``data/pipeline.py:BatchPrefetcher`` and
the host-resident paths of ``train/engine.py``, ``train/cv.py`` and
``train/cv_parallel.py``, each against its device-resident twin.

The cohort is made from numpy seeds. Streaming changes only where a batch
is gathered, so every comparison is bit-equal: the Trainer's epoch (the
state after it, its per-step losses) and evaluation (C-index, loss,
hazards), the sequential driver's and the parallel driver's histories and
fold checkpoints, and the streaming CLI's payload. No test here launches a
CUDA kernel.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.pipeline import (
    BatchPrefetcher,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
)
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)

IMAGE_SHAPE = (16, 16, 8)


@pytest.fixture(autouse=True)
def _vmap_fallback_is_an_error():
    fc = torch._C._functorch
    was, threads = fc._is_vmap_fallback_enabled(), torch.get_num_threads()
    # test workers share the host's cores: more threads only spin
    torch.set_num_threads(min(threads, 2))
    fc._set_vmap_fallback_warning_enabled(True)
    fc._set_vmap_fallback_enabled(False)
    yield
    fc._set_vmap_fallback_enabled(was)
    fc._set_vmap_fallback_warning_enabled(False)
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# BatchPrefetcher
# ---------------------------------------------------------------------------

def _batches(n, pulled=None):
    for i in range(n):
        if pulled is not None:
            pulled.append(i)
        yield {"x": np.full((2, 3), i, np.float32),
               "i": np.array([i], np.int64)}


def test_prefetcher_on_the_cpu_is_a_queue_of_tensors():
    got = list(BatchPrefetcher(_batches(5), depth=2, device="cpu"))
    assert [int(b["i"][0]) for b in got] == list(range(5))
    for i, b in enumerate(got):
        assert b["x"].dtype == torch.float32 and b["i"].dtype == torch.int64
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_keeps_at_most_depth_batches_in_flight(depth):
    """Batches pulled from the iterator and not yet taken by the consumer
    never exceed ``depth``, and the thread does fill the queue."""
    pulled, taken = [], 0
    it = BatchPrefetcher(_batches(8, pulled), depth=depth, device="cpu")
    for _ in range(8):
        want = min(depth, 8 - taken)
        deadline = time.monotonic() + 10
        while len(pulled) - taken < want and time.monotonic() < deadline:
            time.sleep(0.005)  # the producer runs as far ahead as it may
        time.sleep(0.02)  # ... and no further
        assert len(pulled) - taken == want
        next(it)
        taken += 1
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):  # and stays stopped
        next(it)


def test_prefetcher_raises_the_iterators_exception_in_the_consumer():
    def failing():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("bad batch 2")

    it = BatchPrefetcher(failing(), depth=2, device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2))
    with pytest.raises(ValueError, match="bad batch 2"):
        next(it)


def test_prefetcher_close_stops_its_thread():
    before = threading.active_count()
    it = BatchPrefetcher(_batches(100), depth=2, device="cpu")
    next(it)
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    assert threading.active_count() == before


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_prefetcher_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchPrefetcher(_batches(1))


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_cohort")
    table, paths = generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=24, rna_dim=24, seed=4, p_imaging=0.6,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    cfg = dataclasses.replace(ALL_CONFIGS["partial_modality"],
                              image_shape=IMAGE_SHAPE, n_folds=2,
                              num_epochs=2)
    prepared = cv.prepare_cv_data(cfg, table, rnaseq_csv=paths["rnaseq_csv"],
                                  device="cpu")
    return dict(cfg=cfg, prepared=prepared, table=table, paths=paths,
                root=root)


def _equal_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trainer_epoch_and_evaluation_stream_bit_equal(cohort):
    """Two epochs (dropout on) and the pooled evaluation, streaming vs
    device-resident, from the same initial state."""
    cfg = cohort["cfg"]
    arrays, splits = cohort["prepared"]
    train_rows, val_rows, _ = splits[0]
    host = {k: np.asarray(v) for k, v in arrays.arrays.items()}
    data = arrays.to_device("cpu")
    runs = []
    for streaming in (False, True):
        tr = cv.make_trainers(cfg, 24, "simple_cnn", None, "cpu")[0]
        state = tr.init_state(fold=1)
        rng = np.random.default_rng(7)
        losses, steps = [], []
        for _ in range(2):
            if streaming:
                _, loss = tr.train_epoch_streaming(state, host, train_rows,
                                                   rng, 1e-3)
            else:
                _, loss = tr.train_epoch(state, data, train_rows, rng, 1e-3)
            losses.append(loss)
            steps.append(tr.step_losses.clone())
        ev = (tr.evaluate_streaming(state, host, val_rows) if streaming
              else tr.evaluate(state, data, val_rows))
        runs.append((losses, steps, ev, engine.train_state_dict(state)))
    (l0, s0, e0, st0), (l1, s1, e1, st1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert e0[:2] == e1[:2] and np.array_equal(e0[2], e1[2])
    _equal_dicts(st0["model"], st1["model"])
    assert all(torch.equal(a, b) for a, b in zip(st0["opt_mu"],
                                                 st1["opt_mu"]))
    assert all(torch.equal(a, b) for a, b in zip(st0["opt_nu"],
                                                 st1["opt_nu"]))
    assert st0["opt_count"] == st1["opt_count"]
    assert torch.equal(st0["dropout_rng"], st1["dropout_rng"])


@pytest.mark.parametrize("driver", ["sequential", "parallel"])
def test_drivers_stream_bit_equal(driver, cohort, tmp_path):
    """Each driver with ``streaming=True`` gives the device-resident run's
    histories, payload and fold checkpoints, bit for bit."""
    run = (cv.run_cross_validation if driver == "sequential"
           else cv_parallel.run_cross_validation_parallel)
    out = {}
    for streaming in (False, True):
        d = tmp_path / str(streaming)
        out[streaming] = run(cohort["cfg"], None, results_dir=d,
                             models_dir=d, backbone="simple_cnn",
                             prepared=cohort["prepared"],
                             streaming=streaming, device="cpu")
    (p0, o0), (p1, o1) = out[False], out[True]
    assert p0 == p1
    assert [o.history for o in o0] == [o.history for o in o1]
    for fold in (1, 2):
        _equal_dicts(*(load_checkpoint(tmp_path / str(s) / "partial_modality"
                                       / f"fold_{fold}_best.pt")
                       for s in (False, True)))


def test_parallel_streaming_step_equals_the_device_step(cohort):
    """One vmapped epoch of two folds from the host through the prefetcher
    and from the device: the same per-step (steps, K) losses."""
    cfg = cohort["cfg"]
    arrays, splits = cohort["prepared"]
    rows = [s[0] for s in splits]
    host = {k: np.asarray(v) for k, v in arrays.arrays.items()}
    data = arrays.to_device("cpu")
    losses = []
    for streaming in (False, True):
        tr = cv.make_trainers(cfg, 24, "simple_cnn", None, "cpu")[0]
        state = cv_parallel.StackedState([tr.init_state(fold=1),
                                           tr.init_state(fold=2)])
        idx, bv = cv_parallel._stack_fold_indices(
            rows, cfg.batch_size,
            [np.random.default_rng(43), np.random.default_rng(44)])
        batches = cv_parallel.stacked_batches(
            tr, host if streaming else data, idx, bv, streaming=streaming)
        losses.append(cv_parallel._build_parallel_train_epoch(tr)(
            state, batches, bv.max(axis=2) > 0, np.full(2, 1e-3))[0])
    assert losses[0].shape[1] == 2
    assert torch.equal(losses[0], losses[1])


def test_cli_streaming_equals_device_resident(tmp_path):
    """``--streaming`` through the training CLI gives the device-resident
    payload."""
    payloads = []
    for extra in ([], ["--streaming"]):
        d = tmp_path / ("s" if extra else "d")
        payloads.append(pmt.main([
            "--data-root", str(tmp_path / "cohort"), "--results-dir",
            str(d), "--models-dir", str(d), "--synthetic",
            "--synthetic-patients", "16", "--backbone", "simple_cnn",
            "--image-shape", "16,16,8", "--epochs", "1", "--n-folds", "2",
            "--device", "cpu", *extra]))
    assert payloads[0] == payloads[1]
