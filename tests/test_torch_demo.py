"""The serving demo (``demo_e2e.py``) on the CPU: the port's demo against
JAX's ``scripts/serving/demo_e2e.py`` on the same cohort and the same fold
checkpoints (``.msgpack``, written once by the port's writer, whose bytes
are flax's, and reused by both demos), then the port's demo end to end
with ``--retrain``.

Limits: the same holdout patients in the same order, ``calibration.json``'s
per-fold (mu, sd) within 1e-5, each served ``risk_score`` within 1e-4 (the
serving tolerance of ``tests/test_torch_slice.py``), and the same
``serving_summary.json`` keys.
"""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch import demo_e2e
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    save_checkpoint,
    save_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.models.layers import BatchNorm
from multimodal_survival_prediction_tpu_torch.preprocess.tables import (
    read_table,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)

ROOT = Path(__file__).resolve().parents[1]
RNA_DIM = 24
IMAGE = (12, 12, 8)
CAL_TOL = 1e-5
RISK_TOL = 1e-4
FLAGS = ["--n-folds", "2", "--epochs", "1", "--backbone", "simple_cnn",
         "--image-shape", ",".join(map(str, IMAGE)), "--serve-batch", "4"]


@pytest.fixture(scope="module")
def demo_tree(tmp_path_factory):
    """A 28-patient cohort and two seeded partial_modality fold
    checkpoints in .msgpack with their .meta.json."""
    root = tmp_path_factory.mktemp("demo")
    generate_synthetic_cohort(root / "cohort", SyntheticCohortSpec(
        n_patients=28, rna_dim=RNA_DIM, seed=8, p_imaging=0.8,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    cfg = ALL_CONFIGS["partial_modality"]
    for fold in (1, 2):
        gen = torch.Generator().manual_seed(10 + fold)
        model = make_model_and_adapters(cfg, rna_dim=RNA_DIM,
                                        backbone="simple_cnn",
                                        generator=gen)[0]
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        ckpt = root / "models" / cfg.name / f"fold_{fold}_best.msgpack"
        save_checkpoint(ckpt, model.state_dict(), model_name=cfg.name)
        save_fold_meta(ckpt, model=cfg.name, backbone="simple_cnn",
                       image_shape=list(IMAGE), rna_dim=RNA_DIM,
                       use_pallas_resample=False)
    return root


def _run_jax_demo(argv, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["demo_e2e.py", *argv])
        with pytest.raises(SystemExit) as exc:
            runpy.run_path(str(ROOT / "scripts" / "serving" / "demo_e2e.py"),
                           run_name="__main__")
    assert exc.value.code == 0


def _predictions(out: Path) -> dict:
    t = read_table(out / "serving_predictions.csv")
    return {c: t.column(c) for c in t.columns}


def test_demo_matches_jax_on_the_same_folds(demo_tree, tmp_path,
                                            monkeypatch, capsys):
    common = ["--data-root", str(demo_tree / "cohort"), "--models-dir",
              str(demo_tree / "models"), *FLAGS]
    mine = demo_e2e.main([*common, "--out-dir", str(tmp_path / "port"),
                          "--device", "cpu"])
    _run_jax_demo([*common, "--out-dir", str(tmp_path / "jax")], monkeypatch)
    printed = capsys.readouterr().out
    assert printed.count("[demo] reusing 2 fold checkpoints") == 2

    got, want = _predictions(tmp_path / "port"), _predictions(tmp_path / "jax")
    assert list(got) == list(want) == list(demo_e2e.PREDICTION_COLUMNS)
    assert got["patient_id"] == want["patient_id"]
    assert len(got["patient_id"]) == mine["n_holdout"] >= 4
    for c in ("survival_time", "event", "modalities_used"):
        assert got[c] == want[c], c
    np.testing.assert_allclose(got["risk_score"], want["risk_score"],
                               rtol=0, atol=RISK_TOL)

    cal = [json.loads((tmp_path / d / "calibration.json").read_text())
           for d in ("port", "jax")]
    assert cal[0]["model"] == cal[1]["model"]
    assert cal[0]["checkpoints"] == cal[1]["checkpoints"]
    np.testing.assert_allclose(cal[0]["stats"], cal[1]["stats"], rtol=0,
                               atol=CAL_TOL)

    summary = [json.loads((tmp_path / d / "serving_summary.json").read_text())
               for d in ("port", "jax")]
    assert list(summary[0]) == list(summary[1])
    assert summary[0] == mine
    for k in ("model", "n_holdout", "n_http_requests", "folds", "backbone"):
        assert summary[0][k] == summary[1][k], k
    assert sorted(p.name for p in (tmp_path / "port" / "evaluation")
                  .iterdir()) == sorted(p.name for p in (
                      tmp_path / "jax" / "evaluation").iterdir())


def test_demo_retrains_end_to_end(demo_tree, tmp_path, capsys):
    """``--retrain`` over a copy of the .msgpack folds: the CV driver
    trains two .pt folds in their place, calibration, serving through
    /score_batch and the evaluation follow."""
    import shutil

    models = tmp_path / "models"
    shutil.copytree(demo_tree / "models", models)
    out = demo_e2e.main(["--data-root", str(demo_tree / "cohort"),
                         "--models-dir", str(models), "--out-dir",
                         str(tmp_path / "out"), "--retrain", "--device",
                         "cpu", *FLAGS])
    printed = capsys.readouterr().out
    assert "[demo] trained partial_modality (2 folds, 1 epochs)" in printed
    assert "[demo] walls s " in printed
    folds = sorted(p.name for p in (models / "partial_modality").iterdir())
    assert folds == ["fold_1_best.pt", "fold_1_best.pt.meta.json",
                     "fold_2_best.pt", "fold_2_best.pt.meta.json"]
    assert out["folds"] == 2
    assert out["n_http_requests"] == -(-out["n_holdout"] // 4)  # --serve-batch
    pred = _predictions(tmp_path / "out")
    assert np.all(np.isfinite(pred["risk_score"]))
    assert (tmp_path / "out" / "evaluation" / "evaluation_summary.json") \
        .exists()
