"""The port's K-fold CV driver, its artifacts and its training CLIs against
the JAX package, on the CPU (``train/kfold.py``, ``train/cv.py``,
``train/cli.py`` and every family's entry point, ``io/results.py``, the
resume state of ``io/checkpoint.py``, SimMLM's adapters).

Inputs come from numpy seeds and go to both sides. Tolerances:
  * KFold splits, cohort splits, payload files, schedules' LR histories,
    best epochs and sizes: exact;
  * cohort arrays: 1e-6 (both sides resample on the CPU, plain);
  * a CV run from the JAX driver's initial weights, dropout off on both
    sides: train loss rtol 1e-4 per fold and epoch (f32 on both sides,
    three epochs of Adam), val C-index 1e-6 unless a comparable pair whose
    two hazards differ by under 1e-5 explains the difference, C-index mean
    and std 1e-6;
  * resume: bit-equal on the CPU;
  * SimMLM's losses and gradients: 1e-5 relative; the rnaseq_only and
    two-stage simmim driver runs: every epoch's train loss (stage 1's too)
    rtol 1e-4, the rest as above; each family's CLI: C-index from its
    checkpoints as above, RiskScorer vs the ensemble 1e-4.
No test here launches a CUDA kernel: every launch counter stays 0.
"""

import dataclasses
import importlib
import json

import flax.linen as fnn
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu import utils as jutils
from multimodal_survival_prediction_tpu.data.synthetic import (
    SyntheticCohortSpec as JSpec,
)
from multimodal_survival_prediction_tpu.data.synthetic import (
    generate_synthetic_cohort as jgen,
)
from multimodal_survival_prediction_tpu.io import results as jresults
from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu.train import cv as jcv
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu_torch import utils as tutils
from multimodal_survival_prediction_tpu_torch.config import (
    ALL_CONFIGS,
    PARTIAL_MODALITY,
)
from multimodal_survival_prediction_tpu_torch.data.datasets import CohortArrays
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.io import results as tresults
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.ops import resample as rs
from multimodal_survival_prediction_tpu_torch.ops.cindex import (
    concordance_index,
)
from multimodal_survival_prediction_tpu_torch.train import cli, cv, engine
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_adapters,
)
from multimodal_survival_prediction_tpu_torch.train.kfold import kfold_split
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
    predict_risk,
)


@pytest.fixture(autouse=True)
def _no_cached_jax_tracers():
    """The JAX package caches its interpolation matrices
    (``ops/resample.py:_matrices``, an ``lru_cache``) and fills the cache
    inside a jit trace, so it can hold tracers; a later trace of the same
    shapes with another ``hu_window`` or dtype (in this file or in another
    one that this worker runs next, e.g. tests/test_resample.py) would then
    raise UnexpectedTracerError. Each test starts and ends with it empty."""
    jr._matrices.cache_clear()
    yield
    jr._matrices.cache_clear()


IMAGE_SHAPE = (16, 16, 8)
SPEC = dict(n_patients=16, rna_dim=24, seed=0, p_imaging=0.6,
            image_shapes=((12, 20, 20), (10, 18, 16)))
CFG = dataclasses.replace(PARTIAL_MODALITY, image_shape=IMAGE_SHAPE,
                          n_folds=2, num_epochs=3)
JCFG = jconfig.PARTIAL_MODALITY.with_overrides(image_shape=IMAGE_SHAPE,
                                               n_folds=2, num_epochs=3)


def _launches():
    return [k.launches for k in fd.KERNELS] + [rs.wpass.launches]


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity (the JAX models
    hard-code a 0.3 rate)."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


# ---------------------------------------------------------------------------
# KFold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [
    (10, 3, 42), (12, 3, 42), (12, 2, 42), (13, 2, 7), (25, 5, 42),
    (23, 5, 7), (9, 3, 7), (6, 2, 0)])
def test_kfold_matches_sklearn(n, k, seed):
    want = list(KFold(n_splits=k, shuffle=True,
                      random_state=seed).split(np.arange(n)))
    got = kfold_split(n, k, seed)
    assert len(got) == len(want) == k
    for (tr, va), (wtr, wva) in zip(got, want):
        assert tr.tolist() == wtr.tolist()
        assert va.tolist() == wva.tolist()
        assert np.all(np.diff(tr) > 0) and np.all(np.diff(va) > 0)


def test_kfold_refuses_what_sklearn_refuses():
    for n, k in ((3, 4), (5, 1)):
        with pytest.raises(ValueError):
            KFold(n_splits=k, shuffle=True, random_state=0).split(
                np.arange(n)).__next__()
        with pytest.raises(ValueError):
            kfold_split(n, k, 0)


@pytest.mark.parametrize("s", [None, "", "-150,250", "0,100.5"])
def test_parse_hu_window_matches_jax(s):
    assert tutils.parse_hu_window(s) == jutils.parse_hu_window(s)


# ---------------------------------------------------------------------------
# Cohort preparation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """One synthetic cohort on disk (the JAX generator), its table as the
    JAX driver reads it (a DataFrame) and as the port reads it (row
    dicts), and both drivers' prepared cohorts."""
    root = tmp_path_factory.mktemp("cv_cohort")
    jtable, paths = jgen(root, JSpec(**SPEC))
    rows = load_matching_table(paths["matching_table"])
    jprepared = jcv.prepare_cv_data(JCFG, jtable, rnaseq_csv=paths[
        "rnaseq_csv"], resample="device")
    tprepared = cv.prepare_cv_data(CFG, rows, rnaseq_csv=paths["rnaseq_csv"],
                                   resample="device", device="cpu")
    return dict(jtable=jtable, rows=rows, paths=paths, jprepared=jprepared,
                tprepared=tprepared)


def test_prepare_cv_data_matches_jax(cohort):
    (jarr, jsplits), (tarr, tsplits) = cohort["jprepared"], cohort[
        "tprepared"]
    assert list(tarr.patient_ids) == list(jarr.patient_ids)
    assert tarr.ingest_mode == jarr.ingest_mode == "device"
    assert sorted(tarr.arrays) == sorted(jarr.arrays)
    for k, want in jarr.arrays.items():
        got = tarr.arrays[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
    assert len(tsplits) == len(jsplits) == 2
    for (tr, va, tss), (jtr, jva, jtss) in zip(tsplits, jsplits):
        assert tr.tolist() == jtr.tolist()
        assert va.tolist() == jva.tolist()
        assert tss == jtss
    # the partial-modality trick: every unlabeled row in every train set
    unlabeled = set(np.nonzero(tarr.arrays["svalid"] == 0)[0].tolist())
    assert unlabeled and all(unlabeled <= set(tr.tolist())
                             for tr, _, _ in tsplits)


# ---------------------------------------------------------------------------
# cv_results.json
# ---------------------------------------------------------------------------

FOLDS = [
    {"fold": 1, "best_c_index": 0.61, "best_epoch": 13, "train_size": 176,
     "val_size": 88},
    {"fold": 2, "best_c_index": 0.59, "best_epoch": 35, "train_size": 176,
     "val_size": 88},
]
PM_FOLDS = [dict(f, train_survival_size=150) for f in FOLDS]
HYPER = {"batch_size": 8, "learning_rate": 1e-4, "epochs": 50, "n_folds": 2,
         "gate_entropy_weight": 0.01}
EXTRA = {"n_folds": 2, "num_epochs": 50, "dataset_size": 264}


@pytest.mark.parametrize("legacy", [False, True], ids=["standard", "legacy"])
def test_payload_matches_jax(tmp_path, legacy):
    name = None if legacy else "Partial Modality (Gated)"
    kw = dict(hyperparameters=HYPER, extra=EXTRA, legacy=legacy)
    assert tresults.build_cv_payload(name, PM_FOLDS, **kw) == \
        jresults.build_cv_payload(name, PM_FOLDS, **kw)
    assert tresults.write_cv_results(tmp_path / "port", name, PM_FOLDS,
                                     **kw) == \
        jresults.write_cv_results(tmp_path / "jax", name, PM_FOLDS, **kw)
    text = (tmp_path / "port" / "cv_results.json").read_text()
    assert text == (tmp_path / "jax" / "cv_results.json").read_text()
    for d in ("port", "jax"):
        assert tresults.load_cv_results(tmp_path / d) == \
            jresults.load_cv_results(tmp_path / d)


# The cases of tests/test_results_schema.py, on both writers.
WRITERS = {"port": tresults, "jax": jresults}


@pytest.mark.parametrize("writer", list(WRITERS))
def test_standard_schema(tmp_path, writer):
    mod = WRITERS[writer]
    payload = mod.write_cv_results(
        tmp_path, "RNASeq-Only", FOLDS,
        hyperparameters={"batch_size": 16, "learning_rate": 1e-4,
                         "epochs": 50, "n_folds": 3},
        extra={"n_folds": 3, "num_epochs": 50, "dataset_size": 264})
    on_disk = json.load(open(tmp_path / "cv_results.json"))
    assert list(on_disk)[:4] == ["model", "n_folds", "num_epochs",
                                 "dataset_size"]
    assert on_disk["model"] == "RNASeq-Only"
    assert on_disk["c_index_mean"] == payload["c_index_mean"]
    assert isinstance(on_disk["fold_results"], list)
    assert on_disk["hyperparameters"]["batch_size"] == 16


@pytest.mark.parametrize("writer", list(WRITERS))
def test_legacy_schema(tmp_path, writer):
    WRITERS[writer].write_cv_results(tmp_path, None, FOLDS, legacy=True)
    on_disk = json.load(open(tmp_path / "cv_results.json"))
    assert "model" not in on_disk
    assert "hyperparameters" not in on_disk
    assert {"c_index_mean", "c_index_std", "fold_results"} <= set(on_disk)


@pytest.mark.parametrize("writer", list(WRITERS))
def test_tolerant_reader_both_variants(tmp_path, writer):
    mod = WRITERS[writer]
    a, b = tmp_path / "std", tmp_path / "legacy"
    mod.write_cv_results(a, "X", FOLDS, hyperparameters={"batch_size": 8})
    mod.write_cv_results(b, None, FOLDS, legacy=True)
    ra, rb = tresults.load_cv_results(a), tresults.load_cv_results(b)
    assert ra["model"] == "X"
    assert rb["model"] == "legacy"  # falls back to the directory's name
    assert ra["fold_scores"] == rb["fold_scores"] == [0.61, 0.59]
    assert abs(ra["c_index_mean"] - 0.6) < 1e-9


@pytest.mark.parametrize("writer", list(WRITERS))
def test_std_is_population_std(tmp_path, writer):
    payload = WRITERS[writer].write_cv_results(tmp_path, "X", FOLDS)
    assert payload["c_index_std"] == float(np.std([0.61, 0.59]))


# ---------------------------------------------------------------------------
# The driver against the JAX driver
# ---------------------------------------------------------------------------

def _tree_sd(params, batch_stats, name):
    import jax

    tree = jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": batch_stats})
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_import.export_torch_state_dict(name, tree).items()}


def _torch_sd(state, name="partial_modality"):
    return _tree_sd(state.params, state.batch_stats, name)


def _record_evaluations(monkeypatch, trainer_cls, out):
    """Record each ``evaluate``'s (C-index, hazards) into ``out``."""
    evaluate = trainer_cls.evaluate

    def recorded(self, state, data, indices):
        c, loss, h = evaluate(self, state, data, indices)
        out.append((c, np.asarray(h, np.float64), np.asarray(indices)))
        return c, loss, h

    monkeypatch.setattr(trainer_cls, "evaluate", recorded)


def _c_index_tolerance(arrays, rows, hazards, margin=1e-5):
    """1e-6 plus the share of comparable pairs among ``rows`` whose two
    hazards differ by under ``margin`` (their order may flip)."""
    t = arrays["time"][rows]
    e = arrays["event"][rows] > 0
    v = arrays["svalid"][rows] > 0
    comp = ((t[:, None] < t[None, :]) & e[:, None]) | (
        (t[:, None] == t[None, :]) & e[:, None] & ~e[None, :])
    comp &= v[:, None] & v[None, :]
    near = np.abs(hazards[:, None] - hazards[None, :]) < margin
    return 1e-6 + (comp & near).sum() / max(comp.sum(), 1)


def test_driver_matches_jax(cohort, tmp_path, monkeypatch):
    """Two folds of three epochs (simple_cnn, 16x16x8, 24 genes) from the
    JAX driver's initial weights, dropout off on both sides, on the same
    prepared cohort."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    jarr, splits = cohort["jprepared"]
    inits, jevals, tevals = {}, [], []

    def capture(fold, state):
        inits[fold] = _torch_sd(state)

    def start_from_jax(fold, state):
        state.model.load_state_dict(inits[fold], strict=True)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0

    _record_evaluations(monkeypatch, jengine.Trainer, jevals)
    _record_evaluations(monkeypatch, engine.Trainer, tevals)
    jpayload, jout = jcv.run_cross_validation(
        JCFG, None, results_dir=tmp_path / "jax_results",
        models_dir=tmp_path / "jax_models", backbone="simple_cnn",
        prepared=(jarr, splits), init_hook=capture)
    tarr = CohortArrays(patient_ids=list(jarr.patient_ids),
                        arrays={k: v.copy() for k, v in jarr.arrays.items()},
                        ingest_mode=jarr.ingest_mode)
    before = _launches()
    payload, out = cv.run_cross_validation(
        CFG, None, results_dir=tmp_path / "port_results",
        models_dir=tmp_path / "port_models", backbone="simple_cnn",
        prepared=(tarr, splits), init_hook=start_from_jax, device="cpu")
    assert _launches() == before

    assert len(out) == len(jout) == 2 and len(tevals) == len(jevals) == 6
    evals = iter(zip(tevals, jevals))
    for o, jo in zip(out, jout):
        for field in ("fold", "best_epoch", "epochs_run", "train_size",
                      "val_size", "train_survival_size"):
            assert getattr(o, field) == getattr(jo, field), field
        assert [h["lr"] for h in o.history] == [h["lr"] for h in jo.history]
        for h, jh in zip(o.history, jo.history):
            np.testing.assert_allclose(h["train_loss"], jh["train_loss"],
                                       rtol=1e-4)
            (c, _, rows), (jc, jhaz, jrows) = next(evals)
            assert rows.tolist() == jrows.tolist()
            assert c == h["val_c_index"] and jc == jh["val_c_index"]
            assert abs(c - jc) <= _c_index_tolerance(jarr.arrays, rows, jhaz)
    for key in ("c_index_mean", "c_index_std"):
        assert abs(payload[key] - jpayload[key]) <= 1e-6, key
    assert {k: v for k, v in payload.items() if not k.startswith("c_index")
            and k != "fold_results"} == \
        {k: v for k, v in jpayload.items() if not k.startswith("c_index")
         and k != "fold_results"}
    for fr, jfr in zip(payload["fold_results"], jpayload["fold_results"]):
        assert abs(fr.pop("best_c_index") - jfr.pop("best_c_index")) <= \
            max(_c_index_tolerance(jarr.arrays, rows, jhaz)
                for _, (_, jhaz, rows) in zip(tevals, jevals))
        assert fr == jfr
    for fold in (1, 2):
        meta = load_fold_meta(tmp_path / "port_models" / "partial_modality"
                              / f"fold_{fold}_best.pt")
        jmeta = load_fold_meta(tmp_path / "jax_models" / "partial_modality"
                               / f"fold_{fold}_best.msgpack")
        assert sorted(meta) == sorted(jmeta)
        for k in meta:
            if k != "best_c_index":
                assert meta[k] == jmeta[k], k


def test_port_follows_float64_where_jax_departs(tmp_path):
    """On the cohort of seed 3 the JAX driver's fold-1 first step leaves
    exact arithmetic: a ReLU input of its simple CNN lies next to the
    kink, the two frameworks' f32 gradients of the CNN's first layers
    part by up to a tenth of their size, and Adam carries that past the
    driver test's rtol 1e-4 on the train loss by epoch 3. Run in float64,
    the step agrees with the port, not with JAX. So the driver test runs on
    seed 0, and this test holds the port's f32 gradients of that step, from
    the JAX driver's fold-1 initial weights, against the same step in
    float64: every parameter to 1e-4 of its largest |gradient| + 1e-6."""
    jtable, paths = jgen(tmp_path, JSpec(**dict(SPEC, seed=3)))
    jarr, splits = jcv.prepare_cv_data(JCFG, jtable, rnaseq_csv=paths[
        "rnaseq_csv"], resample="device")
    jtr = jengine.Trainer(*jadapters.make_model_and_adapters(
        JCFG, rna_dim=SPEC["rna_dim"], backbone="simple_cnn"),
        jengine.TrainConfig(batch_size=8))
    example = {k: v[:8] for k, v in jarr.to_device().items()}
    example["valid"] = example["svalid"]
    init = _torch_sd(jtr.init_state(example, fold=1))
    perm, bvalid = engine.Trainer._pad_indices(
        splits[0][0], 8, np.random.default_rng(CFG.seed + 1))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tr = engine.Trainer(lambda g: PartialModalityNet(
            rna_dim=SPEC["rna_dim"], backbone="simple_cnn", dropout=0.0,
            generator=g).to(dtype), *make_adapters(CFG), device="cpu")
        state = tr.init_state(fold=1)
        state.model.load_state_dict(init, strict=True)
        data = {k: torch.from_numpy(v).to(dtype)
                for k, v in jarr.arrays.items()}
        batch = tr._gather_batch(data, torch.from_numpy(perm[0]).long(),
                                 torch.from_numpy(bvalid[0]).to(dtype))
        grads[dtype] = tr.loss_and_grads(state, batch)[1]
    for g, want in zip(grads[torch.float32], grads[torch.float64]):
        scale = float(want.abs().max())
        assert float((g.double() - want).abs().max()) <= 1e-4 * scale + 1e-6


def test_resume_is_bit_equal(cohort, tmp_path, monkeypatch):
    """A run stopped right after fold 1's epoch-2 resume save, then resumed,
    ends where an uninterrupted run does: the same history, best epoch and
    fold checkpoints, bit for bit (dropout on)."""
    tarr, splits = cohort["tprepared"]
    kw = dict(backbone="simple_cnn", prepared=(tarr, splits), resume=True,
              checkpoint_every=2, num_epochs=4, device="cpu")
    whole = cv.run_cross_validation(
        CFG, None, results_dir=tmp_path / "a", models_dir=tmp_path / "a", **kw)

    train_epoch, calls = engine.Trainer.train_epoch, []

    def stop_at_epoch_3(self, *a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt("stopped")
        return train_epoch(self, *a, **k)

    monkeypatch.setattr(engine.Trainer, "train_epoch", stop_at_epoch_3)
    with pytest.raises(KeyboardInterrupt):
        cv.run_cross_validation(CFG, None, results_dir=tmp_path / "b",
                                models_dir=tmp_path / "b", **kw)
    progress = json.loads((tmp_path / "b" / "partial_modality"
                           / "fold_1_resume" / "progress.json").read_text())
    assert progress["epoch"] == 2
    monkeypatch.setattr(engine.Trainer, "train_epoch", train_epoch)
    resumed = cv.run_cross_validation(
        CFG, None, results_dir=tmp_path / "b", models_dir=tmp_path / "b", **kw)

    assert resumed[0] == whole[0]
    for o, w in zip(resumed[1], whole[1]):
        assert (o.history, o.best_epoch, o.best_c_index, o.epochs_run) == \
            (w.history, w.best_epoch, w.best_c_index, w.epochs_run)
        name = f"partial_modality/fold_{o.fold}_best.pt"
        got = load_checkpoint(tmp_path / "b" / name)
        want = load_checkpoint(tmp_path / "a" / name)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert whole[1][0].history[-1]["epoch"] == 4


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option,item", [
    (dict(streaming=True), "Queue 1 item 11"),
    (dict(mesh=object()), "Queue 1 item 10"),
    (dict(tensor_parallel=True), "Queue 1 item 10"),
    (dict(sharded_risk_set=True), "Queue 1 item 10"),
    (dict(aot_cache_dir="aot"), "Queue 1 item 12"),
    (dict(profile_dir="prof"), "Queue 1 item 11"),
    (dict(remat=True), "Queue 1 item 16"),
])
def test_driver_refuses_what_is_not_ported(tmp_path, option, item):
    with pytest.raises(NotImplementedError, match=item):
        cv.run_cross_validation(CFG, [], results_dir=tmp_path,
                                models_dir=tmp_path, device="cpu", **option)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "4"], "Queue 1 item 10"),
    (["--fold-parallel", "2"], "Queue 1 item 9"),
    (["--fold-dp", "2"], "Queue 1 item 9"),
    (["--tp", "2"], "Queue 1 item 10"),
    (["--remat"], "Queue 1 item 16"),
    (["--streaming"], "Queue 1 item 11"),
    (["--sharded-risk-set"], "Queue 1 item 10"),
    (["--multihost"], "Queue 1 item 10"),
    (["--aot-cache", "aot"], "Queue 1 item 12"),
    (["--profile-dir", "prof"], "Queue 1 item 11"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_cli_refuses_what_is_not_ported(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        pmt.main(["--data-root", str(tmp_path), "--synthetic", "--device",
                  "cpu", *flag])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# The CLI end to end
# ---------------------------------------------------------------------------

def test_cli_end_to_end_on_cpu(tmp_path, caplog):
    """``main`` on a synthetic cohort writes cv_results.json and both fold
    checkpoints with their .meta.json; predict_risk loads them strictly and
    each fold's scores on its validation patients reproduce its
    best_c_index. No kernel launches on the CPU."""
    before = _launches()
    results, models = tmp_path / "results", tmp_path / "models"
    with caplog.at_level("INFO", logger=cli.__name__):
        payload = pmt.main([
            "--data-root", str(tmp_path), "--results-dir", str(results),
            "--models-dir", str(models), "--synthetic",
            "--synthetic-patients", "16", "--backbone", "simple_cnn",
            "--image-shape", "16,16,8", "--epochs", "2", "--n-folds", "2",
            "--device", "cpu"])
    assert "torch.backends.cuda.matmul.allow_tf32=False, " \
        "torch.backends.cudnn.allow_tf32=False" in caplog.text
    loaded = tresults.load_cv_results(results / "partial_modality")
    assert loaded["raw"] == payload
    assert loaded["model"] == PARTIAL_MODALITY.display_name
    assert loaded["hyperparameters"] == {
        "batch_size": 8, "learning_rate": 1e-4, "epochs": 2, "n_folds": 2,
        "gate_entropy_weight": 0.01}
    assert len(loaded["fold_scores"]) == 2

    table = load_matching_table(
        tmp_path / "data" / "processed" / "full_matching_table.csv")
    rna_csv = tmp_path / "data" / "processed" / "rnaseq_normalized_mapped.csv"
    arrays, splits = cv.prepare_cv_data(
        dataclasses.replace(CFG, n_folds=2), table, rnaseq_csv=rna_csv,
        device="cpu")
    paths = fold_checkpoints(models, "partial_modality")
    assert [p.name for p in paths] == ["fold_1_best.pt", "fold_2_best.pt"]
    for path, fold, (_, val_rows, _) in zip(paths, payload["fold_results"],
                                            splits):
        meta = load_fold_meta(path)
        assert meta["backbone"] == "simple_cnn"
        assert meta["image_shape"] == list(IMAGE_SHAPE)
        assert meta["use_pallas_resample"] is False
        assert meta["resample_mode"] == "device"
        assert meta["best_epoch"] == fold["best_epoch"]
        pred = predict_risk(PARTIAL_MODALITY, path, table, rnaseq_csv=rna_csv,
                            labeled_only=False, device="cpu")
        assert list(pred["patient_id"]) == list(arrays.patient_ids)
        h = pred["risk_score"][val_rows]
        c = float(concordance_index(
            torch.from_numpy(h), arrays.arrays["time"][val_rows],
            arrays.arrays["event"][val_rows],
            valid=arrays.arrays["svalid"][val_rows]))
        assert abs(c - fold["best_c_index"]) <= _c_index_tolerance(
            arrays.arrays, val_rows, h.astype(np.float64))
    ensemble = predict_risk(PARTIAL_MODALITY, paths, table,
                            rnaseq_csv=rna_csv, device="cpu")
    assert np.all(np.isfinite(ensemble["risk_score"]))
    assert _launches() == before


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_clis_pin_fp32(monkeypatch, capsys, caplog, tmp_path, entry):
    """Both of the port's CLIs turn TF32 off for cuDNN and matmuls and say
    so; the flags are process-wide, so the library leaves them alone."""
    from multimodal_survival_prediction_tpu_torch import serving

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    want = ("torch.backends.cuda.matmul.allow_tf32=False, "
            "torch.backends.cudnn.allow_tf32=False")
    if entry == "serve":
        class _Server:
            server_address = ("127.0.0.1", 0)

            def serve_forever(self):
                raise KeyboardInterrupt

            def server_close(self):
                pass

        monkeypatch.setattr(serving, "RiskScorer", lambda *a, **k:
                            type("S", (), {"cfg": PARTIAL_MODALITY})())
        monkeypatch.setattr(serving, "make_server", lambda *a, **k: _Server())
        serving.main(["--checkpoint", "fold_1_best.pt", "--device", "cpu"])
        assert want in capsys.readouterr().out
    else:
        monkeypatch.setattr(cli, "run_cross_validation", lambda *a, **k: (
            {"c_index_mean": 0.5, "c_index_std": 0.0}, []))
        with caplog.at_level("INFO", logger=cli.__name__):
            pmt.main(["--data-root", str(tmp_path), "--synthetic",
                      "--synthetic-patients", "4", "--device", "cpu"])
        assert want in caplog.text
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# The other families: SimMLM's losses, the driver for rnaseq_only and the
# two-stage simmim, every family's CLI
# ---------------------------------------------------------------------------

FAMILY_SPEC = dict(n_patients=32, rna_dim=24, seed=5, p_imaging=0.6,
                   image_shapes=((12, 20, 20), (10, 18, 16)))


def _simmlm_batch(n=8, seed=9):
    """Rows without CT, RNA or age, one with no modality, two unlabeled,
    a tied time; the port's and JAX's batch layout."""
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 3), np.float32)
    mask[1, 0] = mask[2, 1] = mask[4, 2] = 0.0
    mask[5] = 0.0
    svalid = np.ones(n, np.float32)
    svalid[[3, 7]] = 0.0
    time = rng.integers(5, 60, n).astype(np.float32) * svalid
    time[6] = time[0]
    event = (rng.uniform(size=n) < 0.6).astype(np.float32) * svalid
    event[0] = event[6] = 1.0
    return {
        "image": (rng.normal(size=(n, *IMAGE_SHAPE, 1))
                  * mask[:, 0, None, None, None, None]).astype(np.float32),
        "rnaseq": (rng.normal(size=(n, 24)) * mask[:, 1:2]).astype(
            np.float32),
        "clinical": (rng.uniform(0.3, 0.8, (n, 1)) * mask[:, 2:3]).astype(
            np.float32),
        "mask": mask, "time": time, "event": event, "svalid": svalid,
        "valid": np.ones(n, np.float32),
    }


@pytest.mark.parametrize("stage", ["main", "stage1"])
def test_simmlm_losses_and_grads_match_jax(stage, monkeypatch):
    """SimMLM's MoFe loss (ensemble Cox + λ · the experts' mean Cox) and its
    stage-1 loss (the experts alone, main_scale 0) and their gradients, from
    the JAX init carried across, dropout off: 1e-5 relative (each gradient
    to 1e-5 of its largest |value|, + 1e-7; the conv biases whose gradient
    is 0 in exact arithmetic to 1e-6 of the model's largest gradient)."""
    import jax

    from multimodal_survival_prediction_tpu_torch.config import SIMMLM
    from multimodal_survival_prediction_tpu_torch.models import (
        SimMLMSurvivalNet,
    )
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        simmlm_stage1_adapter,
    )

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    arrays = _simmlm_batch()
    kw = dict(batch_size=8, learning_rate=SIMMLM.learning_rate)
    jm, jb2i, jhaa = jadapters.make_model_and_adapters(
        jconfig.SIMMLM, rna_dim=24, backbone="simple_cnn")
    if stage == "stage1":
        jhaa = jadapters.simmlm_stage1_adapter()
    jtr = jengine.Trainer(jm, jb2i, jhaa, jengine.TrainConfig(**kw))
    jdata = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
    jstate = jtr.init_state(jdata, fold=1)
    (jloss, _), jgrads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        jstate.params, jstate.batch_stats, jdata, jax.random.PRNGKey(0))
    jgrad_sd = _tree_sd(jgrads, jstate.batch_stats, "simmim")

    b2i, haa = make_adapters(SIMMLM)
    tr = engine.Trainer(
        lambda g: SimMLMSurvivalNet(rna_dim=24, backbone="simple_cnn",
                                    generator=g),
        b2i, simmlm_stage1_adapter() if stage == "stage1" else haa,
        engine.TrainConfig(**kw), device="cpu")
    state = tr.init_state(fold=1)
    state.model.load_state_dict(_torch_sd(jstate, "simmim"), strict=True)
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    loss, grads = tr.loss_and_grads(
        state, {k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    names = [n for n, _ in state.model.named_parameters()]
    top = max(float(np.abs(jgrad_sd[n].numpy()).max()) for n in names)
    # the CNN's conv biases feed a train-mode BatchNorm, which removes any
    # shift: their gradient is 0 in exact arithmetic, rounding noise here
    shifts = {f"expert_image.encoder.{i}.bias" for i in (0, 3, 6)}
    for name, g in zip(names, grads):
        want = jgrad_sd[name].numpy()
        err = float(np.abs(g.numpy() - want).max())
        if name in shifts:
            assert err <= 1e-6 * top, (name, err)
        else:
            assert err <= 1e-5 * float(np.abs(want).max()) + 1e-7, (name, err)
    heads = ("gating.", "ensemble_cox.")
    if stage == "stage1":  # the ensemble's term is off: no gradient there
        assert all(float(g.abs().max()) == 0.0 for n, g in zip(names, grads)
                   if n.startswith(heads))
    else:
        assert any(float(g.abs().max()) > 0.0 for n, g in zip(names, grads)
                   if n.startswith(heads))


@pytest.fixture(scope="module")
def family_cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("family_cohort")
    jtable, paths = jgen(root, JSpec(**FAMILY_SPEC))
    return dict(jtable=jtable, paths=paths, root=root)


def _record_train_losses(monkeypatch, trainer_cls, out):
    train_epoch = trainer_cls.train_epoch

    def recorded(self, *a, **k):
        state, loss = train_epoch(self, *a, **k)
        out.append(loss)
        return state, loss

    monkeypatch.setattr(trainer_cls, "train_epoch", recorded)


def _record_adam_counts(monkeypatch, out):
    """Per port epoch: Adam's count before and after it, and its steps."""
    train_epoch = engine.Trainer.train_epoch

    def recorded(self, state, data, indices, *a, **k):
        before = state.opt_state.count
        state, loss = train_epoch(self, state, data, indices, *a, **k)
        out.append((before, state.opt_state.count,
                    -(-len(indices) // self.cfg.batch_size)))
        return state, loss

    monkeypatch.setattr(engine.Trainer, "train_epoch", recorded)


@pytest.mark.parametrize("name", ["rnaseq_only", "simmim"])
def test_family_driver_matches_jax(name, family_cohort, tmp_path,
                                   monkeypatch, caplog):
    """Two folds of two epochs from the JAX driver's initial weights,
    dropout off: rnaseq_only (AdamW, cosine, batch 16, no clip) and simmim
    with one stage-1 epoch before them (Adam's moments and count carried
    into stage 2 on both sides). Every epoch's train loss (stage 1's too)
    to rtol 1e-4, LR histories and best epochs exact, C-index as in
    test_driver_matches_jax; Adam's count runs on from fold start through
    both stages."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    over = dict(n_folds=2, num_epochs=2, image_shape=IMAGE_SHAPE)
    if name == "simmim":
        over["stage1_epochs"] = 1
    jcfg = jconfig.ALL_CONFIGS[name].with_overrides(**over)
    tcfg = dataclasses.replace(ALL_CONFIGS[name], **over)
    jarr, splits = jcv.prepare_cv_data(
        jcfg, family_cohort["jtable"],
        rnaseq_csv=family_cohort["paths"]["rnaseq_csv"], resample="device")
    inits, jevals, tevals, jlosses, tlosses = {}, [], [], [], []

    def capture(fold, state):
        inits[fold] = _torch_sd(state, name)

    def start_from_jax(fold, state):
        state.model.load_state_dict(inits[fold], strict=True)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0

    _record_evaluations(monkeypatch, jengine.Trainer, jevals)
    _record_evaluations(monkeypatch, engine.Trainer, tevals)
    _record_train_losses(monkeypatch, jengine.Trainer, jlosses)
    _record_train_losses(monkeypatch, engine.Trainer, tlosses)
    counts = []
    _record_adam_counts(monkeypatch, counts)
    jpayload, jout = jcv.run_cross_validation(
        jcfg, None, results_dir=tmp_path / "jax", models_dir=tmp_path / "jax",
        backbone="simple_cnn", prepared=(jarr, splits), init_hook=capture)
    tarr = CohortArrays(patient_ids=list(jarr.patient_ids),
                        arrays={k: v.copy() for k, v in jarr.arrays.items()},
                        ingest_mode=jarr.ingest_mode)
    with caplog.at_level("INFO", logger=cv.__name__):
        payload, out = cv.run_cross_validation(
            tcfg, None, results_dir=tmp_path / "port",
            models_dir=tmp_path / "port", backbone="simple_cnn",
            prepared=(tarr, splits), init_hook=start_from_jax, device="cpu")

    epochs_per_fold = 2 + over.get("stage1_epochs", 0)
    assert len(tlosses) == len(jlosses) == 2 * epochs_per_fold
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    # one optimizer state per fold: stage 2 continues stage 1's moments and
    # count (a fresh optimizer would restart the count at 0)
    assert len(counts) == 2 * epochs_per_fold
    for f in range(2):
        fold = counts[f * epochs_per_fold:(f + 1) * epochs_per_fold]
        assert fold[0][0] == 0
        for (before, after, steps), nxt in zip(fold, fold[1:] + [None]):
            assert after == before + steps
            if nxt is not None:
                assert nxt[0] == after
    assert len(tevals) == len(jevals) == 4
    for o, jo in zip(out, jout):
        for field in ("fold", "best_epoch", "epochs_run", "train_size",
                      "val_size", "train_survival_size"):
            assert getattr(o, field) == getattr(jo, field), field
        assert [h["lr"] for h in o.history] == [h["lr"] for h in jo.history]
    for (c, _, rows), (jc, jhaz, _) in zip(tevals, jevals):
        assert abs(c - jc) <= _c_index_tolerance(jarr.arrays, rows, jhaz)
    assert payload["hyperparameters"] == jpayload["hyperparameters"]
    if name == "simmim":
        assert payload["hyperparameters"]["stage1_epochs"] == 1
        text = caplog.text
        for fold in (1, 2):
            assert text.index(f"[simmim fold {fold}] stage1 epoch 1") < \
                text.index(f"[simmim fold {fold}] epoch 1 ")


def test_stage1_is_skipped_on_resume(family_cohort, tmp_path, monkeypatch):
    """A simmim fold resumed after its epoch-2 save does not run stage 1
    again, and ends where an uninterrupted run does, bit for bit."""
    cfg = dataclasses.replace(ALL_CONFIGS["simmim"], n_folds=2,
                              image_shape=IMAGE_SHAPE, stage1_epochs=1)
    prepared = cv.prepare_cv_data(
        cfg, load_matching_table(family_cohort["paths"]["matching_table"]),
        rnaseq_csv=family_cohort["paths"]["rnaseq_csv"], device="cpu")
    kw = dict(backbone="simple_cnn", prepared=prepared, resume=True,
              checkpoint_every=2, num_epochs=3, device="cpu")
    whole = cv.run_cross_validation(cfg, None, results_dir=tmp_path / "a",
                                    models_dir=tmp_path / "a", **kw)
    train_epoch, calls = engine.Trainer.train_epoch, []

    def stop_in_fold_2(self, *a, **k):
        calls.append(1)
        if len(calls) == 6:  # fold 1: 1 + 3 epochs; fold 2: stage 1, epoch 1
            raise KeyboardInterrupt("stopped")
        return train_epoch(self, *a, **k)

    monkeypatch.setattr(engine.Trainer, "train_epoch", stop_in_fold_2)
    with pytest.raises(KeyboardInterrupt):
        cv.run_cross_validation(cfg, None, results_dir=tmp_path / "b",
                                models_dir=tmp_path / "b", **kw)
    calls.clear()
    monkeypatch.setattr(engine.Trainer, "train_epoch", lambda self, *a, **k:
                        calls.append(1) or train_epoch(self, *a, **k))
    resumed = cv.run_cross_validation(cfg, None, results_dir=tmp_path / "b",
                                      models_dir=tmp_path / "b", **kw)
    # fold 1 resumes at epoch 3 (no stage 1); fold 2 runs whole
    assert len(calls) == 1 + 4
    assert resumed[0] == whole[0]
    for o, w in zip(resumed[1], whole[1]):
        assert (o.history, o.best_epoch, o.best_c_index) == \
            (w.history, w.best_epoch, w.best_c_index)


FAMILY_ENTRIES = {
    "rnaseq_only": "train_rnaseq_only", "image_only": "image_only",
    "simple_fusion": "simple_fusion",
    "flexible_multimodal": "flexible_multimodal",
    "final": "final_multimodal", "simmim": "simmlm", "mmsurv": "mmsurv",
}


@pytest.mark.parametrize("name", list(FAMILY_ENTRIES))
def test_family_cli_end_to_end_on_cpu(name, family_cohort, tmp_path):
    """Each family's ``main`` on the cohort (simple CNN, 16x16x8, 2 folds x
    2 epochs; simmim with one stage-1 epoch): cv_results.json in its
    schema, both fold checkpoints with their .meta.json, each fold's
    C-index reproduced by predict_risk from its checkpoint, and
    RiskScorer on the fold checkpoints (calibrated by predict_risk's fold
    stats) scoring one patient as the ensemble does, within 1e-4."""
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        load_rnaseq_matrix,
    )
    from multimodal_survival_prediction_tpu_torch.serving import RiskScorer

    entry = importlib.import_module(
        f"multimodal_survival_prediction_tpu_torch.train."
        f"{FAMILY_ENTRIES[name]}")
    cfg = ALL_CONFIGS[name]
    paths = family_cohort["paths"]
    results, models = tmp_path / "results", tmp_path / "models"
    extra = ["--stage1-epochs", "1"] if name == "simmim" else []
    before = _launches()
    payload = entry.main([
        "--data-root", str(paths["root"]), "--results-dir", str(results),
        "--models-dir", str(models), "--backbone", "simple_cnn",
        "--image-shape", "16,16,8", "--epochs", "2", "--n-folds", "2",
        "--device", "cpu", *extra])
    loaded = tresults.load_cv_results(results / name)
    assert loaded["raw"] == payload and len(loaded["fold_scores"]) == 2
    if name == "image_only":  # the reference's legacy schema
        assert "model" not in payload and "hyperparameters" not in payload
    else:
        assert payload["model"] == cfg.display_name

    table = load_matching_table(paths["matching_table"])
    arrays, splits = cv.prepare_cv_data(
        dataclasses.replace(cfg, n_folds=2, image_shape=IMAGE_SHAPE), table,
        rnaseq_csv=paths["rnaseq_csv"], device="cpu")
    ckpts = fold_checkpoints(models, name)
    assert [p.name for p in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"]
    for path, (_, val_rows, _), fold in zip(ckpts, splits,
                                            payload["fold_results"]):
        assert load_fold_meta(path)["image_shape"] == list(IMAGE_SHAPE)
        pred = predict_risk(cfg, path, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device="cpu")
        assert list(pred["patient_id"]) == list(arrays.patient_ids)
        h = pred["risk_score"][val_rows]
        c = float(concordance_index(
            torch.from_numpy(h), arrays.arrays["time"][val_rows],
            arrays.arrays["event"][val_rows],
            valid=arrays.arrays["svalid"][val_rows]))
        assert abs(c - fold["best_c_index"]) <= _c_index_tolerance(
            arrays.arrays, val_rows, h.astype(np.float64))

    pred, stats = predict_risk(cfg, ckpts, table,
                               rnaseq_csv=paths["rnaseq_csv"],
                               labeled_only=False, return_fold_stats=True,
                               device="cpu")
    assert np.all(np.isfinite(pred["risk_score"]))
    scorer = RiskScorer(name, ckpts, fold_calibration=stats, device="cpu")
    rna = load_rnaseq_matrix(paths["rnaseq_csv"])
    rows = {r["patient_id"]: r for r in table}
    i, row = next((i, rows[p]) for i, p in enumerate(pred["patient_id"])
                  if rows[p]["has_imaging"] or "image" not in cfg.modalities)
    patient = {}
    if "image" in cfg.modalities and row["has_imaging"]:
        patient["nifti_path"] = row["nifti_path"]
    if "rnaseq" in cfg.modalities and row["patient_id"] in rna.index:
        patient["rnaseq"] = rna.row(row["patient_id"])
    if not np.isnan(row["age"]):
        patient["age"] = row["age"]
    got = scorer.score(**patient)["risk_score"]
    assert abs(got - float(pred["risk_score"][i])) <= 1e-4
    if "image" not in cfg.modalities:
        img = next(r for r in table if r["has_imaging"])
        with pytest.raises(ValueError, match="no image modality"):
            scorer.score(nifti_path=img["nifti_path"], age=60.0)
    assert _launches() == before


def test_final_reads_the_multimodal_table(tmp_path, monkeypatch):
    """``final`` trains on data/processed/multimodal_matching_table.csv
    where it exists (the reference's 109-patient table); the others, and
    ``final`` without it, on full_matching_table.csv."""
    from multimodal_survival_prediction_tpu_torch.train import (
        final_multimodal,
        simple_fusion,
    )

    proc = tmp_path / "data" / "processed"
    proc.mkdir(parents=True)
    head = ("patient_id,has_imaging,has_rnaseq,has_clinical,has_survival,"
            "age,survival_time,survival_status,nifti_path\n")
    (proc / "full_matching_table.csv").write_text(
        head + "TCGA-A,0,0,1,1,50,100,1,\n")
    seen = []
    monkeypatch.setattr(cli, "run_cross_validation", lambda cfg, table, **k: (
        seen.append([r["patient_id"] for r in table]) or
        ({"c_index_mean": 0.5, "c_index_std": 0.0}, [])))
    argv = ["--data-root", str(tmp_path), "--device", "cpu"]
    final_multimodal.main(argv)
    (proc / "multimodal_matching_table.csv").write_text(
        head + "TCGA-B,0,0,1,1,60,200,0,\n")
    final_multimodal.main(argv)
    simple_fusion.main(argv)
    assert seen == [["TCGA-A"], ["TCGA-B"], ["TCGA-A"]]


@pytest.mark.parametrize("entry", ["partial_modality_training", "mmsurv",
                                   "train_rnaseq_only"])
def test_stage1_epochs_refused_without_stage1(tmp_path, entry):
    mod = importlib.import_module(
        f"multimodal_survival_prediction_tpu_torch.train.{entry}")
    with pytest.raises(SystemExit, match="no stage 1"):
        mod.main(["--data-root", str(tmp_path), "--synthetic", "--device",
                  "cpu", "--stage1-epochs", "3"])
    assert not any(tmp_path.iterdir())
