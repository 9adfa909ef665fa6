"""The port's evaluation tools and the server's warm-up, on the CPU.

* ``ops/km.py`` against the JAX package's on the cases of tests/test_km.py
  and on seeded tables with ties: equal to 1e-12.
* ``analysis/evaluate.py`` (a dict of numpy columns) against JAX's (a
  DataFrame): the same ``evaluation_summary.json`` within 1e-12, null
  where JAX writes null (a group whose KM curve never crosses 0.5).
* ``analysis.generate_km_curves``, ``analysis.evaluate_model`` and
  ``tools.calibrate`` end to end on a synthetic cohort with
  ``--device cpu``.
* ``RiskScorer.warmup`` / ``warmup_no_image`` (JAX ``serving.py:245-274``):
  the constructor warms, a second call changes nothing, risks are
  bit-identical with and without an extra warm-up; the server CLI's flags
  reach ``RiskScorer``.
"""

import json
import math

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_survival_prediction_tpu.analysis import evaluate as jeval
from multimodal_survival_prediction_tpu.ops import km as jkm
from multimodal_survival_prediction_tpu_torch import serving
from multimodal_survival_prediction_tpu_torch.analysis import evaluate
from multimodal_survival_prediction_tpu_torch.analysis import (
    evaluate_model,
    generate_km_curves,
)
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.datasets import (
    load_rnaseq_matrix,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    save_checkpoint,
    save_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.models.layers import BatchNorm
from multimodal_survival_prediction_tpu_torch.ops import km
from multimodal_survival_prediction_tpu_torch.ops.cindex import (
    concordance_index_np,
)
from multimodal_survival_prediction_tpu_torch.serving import RiskScorer
from multimodal_survival_prediction_tpu_torch.tools import calibrate
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
    predict_risk,
)

TOL = 1e-12
RNA_DIM = 24
IMAGE = (16, 16, 8)


# ---------------------------------------------------------------------------
# Kaplan-Meier and log-rank
# ---------------------------------------------------------------------------

def _seeded(seed, n=50, ties=True):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1, 100, size=n)
    if ties:
        t = np.round(t / 10) * 10
    return t, (rng.uniform(size=n) < 0.7).astype(int)


KM_CASES = {
    "textbook": ([1, 2, 3, 4, 5], [1, 0, 1, 0, 1]),
    "all_censored": ([1, 2, 3], [0, 0, 0]),
    "median": ([1, 2, 3, 4], [1, 1, 1, 1]),
    "all_dead_ties": ([2, 2, 2, 5], [1, 1, 1, 1]),
    "seeded_ties": _seeded(0),
    "seeded": _seeded(1, ties=False),
}


def _same(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(KM_CASES))
def test_kaplan_meier_matches_jax(case):
    t, e = KM_CASES[case]
    got, want = km.kaplan_meier(t, e), jkm.kaplan_meier(t, e)
    for field in ("timeline", "survival", "at_risk", "observed", "ci_lower",
                  "ci_upper"):
        _same(getattr(got, field), getattr(want, field))
    assert got.median_survival_time == want.median_survival_time
    assert km.median_survival_time(t, e) == jkm.median_survival_time(t, e)
    for q in (0, 1, 2.5, 4.9, 5, 60, 1e3):
        assert got.survival_at(q) == want.survival_at(q)


LOGRANK_CASES = {
    "identical": _seeded(2) * 2,
    "separated": (np.linspace(1, 10, 40), np.ones(40, int),
                  np.linspace(100, 200, 40), np.ones(40, int)),
    "seeded": (*_seeded(3, n=30), *_seeded(4, n=25)),
    "no_events": ([1, 2], [0, 0], [3, 4], [0, 0]),
}


@pytest.mark.parametrize("case", list(LOGRANK_CASES))
def test_logrank_matches_jax(case):
    args = LOGRANK_CASES[case]
    got, want = km.logrank_test(*args), jkm.logrank_test(*args)
    _same(got.test_statistic, want.test_statistic)
    _same(got.p_value, want.p_value)


# ---------------------------------------------------------------------------
# evaluate_predictions and evaluation_summary.json
# ---------------------------------------------------------------------------

def _table(seed, n, p_event):
    rng = np.random.default_rng(seed)
    return {"patient_id": np.asarray([f"P{i:03d}" for i in range(n)],
                                     dtype=object),
            "risk_score": rng.normal(size=n).astype(np.float32),
            "survival_time": np.round(rng.uniform(30, 3000, size=n)
                                      ).astype(np.float32),
            "event": (rng.uniform(size=n) < p_event).astype(np.float32)}


TABLES = {"balanced": (0, 40, 0.6), "odd": (1, 31, 0.5),
          "few_events": (2, 20, 0.1), "ties": (3, 16, 0.7)}


def _assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}/{k}")
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, path
    else:
        assert got is not None and abs(got - want) <= TOL, (path, got, want)


@pytest.mark.parametrize("case", list(TABLES))
def test_evaluation_summary_matches_jax(case, tmp_path):
    pred = _table(*TABLES[case])
    if case == "ties":
        pred["risk_score"][:8] = pred["risk_score"][0]
    evaluate.evaluate_predictions(pred, out_dir=tmp_path / "port")
    jeval.evaluate_predictions(pd.DataFrame(pred), out_dir=tmp_path / "jax")
    got = json.loads((tmp_path / "port" / "evaluation_summary.json").read_text())
    want = json.loads((tmp_path / "jax" / "evaluation_summary.json").read_text())
    _assert_json_close(got, want)
    if case == "few_events":  # a group's curve never reaches 0.5: null
        assert None in (want["risk_groups"]["high"]["median_survival"],
                        want["risk_groups"]["low"]["median_survival"])
    for g, w in zip(evaluate.km_groups(pred),
                    jeval.km_groups(pd.DataFrame(pred))):
        for field in ("survival", "ci_lower", "ci_upper") if hasattr(
                w, "survival") else ("test_statistic", "p_value"):
            _same(getattr(g, field), getattr(w, field))
    got_types = evaluate.km_event_types(pred)
    want_types = jeval.km_event_types(pd.DataFrame(pred))
    assert list(got_types) == list(want_types)
    for k in want_types:
        _same(got_types[k].survival, want_types[k].survival)


def test_predictions_csv_round_trips_exactly(tmp_path):
    pred = _table(5, 12, 0.5)
    evaluate.write_predictions_csv(tmp_path / "p.csv", pred)
    back = evaluate.read_predictions_csv(tmp_path / "p.csv")
    assert list(back["patient_id"]) == list(pred["patient_id"])
    for c in ("risk_score", "survival_time", "event"):
        np.testing.assert_array_equal(back[c], pred[c].astype(np.float64))
    frame = pd.read_csv(tmp_path / "p.csv", float_precision="round_trip")
    np.testing.assert_array_equal(frame.risk_score.to_numpy(),
                                  back["risk_score"])


# ---------------------------------------------------------------------------
# generate_km_curves -> evaluate_model, calibrate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scored_cohort(tmp_path_factory):
    """A partial_modality simple-CNN cohort with two seeded fold
    checkpoints: fold 1 as .msgpack, fold 2 as .pt."""
    root = tmp_path_factory.mktemp("analysis")
    table, paths = generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=16, rna_dim=RNA_DIM, seed=4, p_imaging=0.6,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    cfg = ALL_CONFIGS["partial_modality"]
    models = root / "models"
    for fold, suffix in ((1, ".msgpack"), (2, ".pt")):
        gen = torch.Generator().manual_seed(fold)
        model = make_model_and_adapters(cfg, rna_dim=RNA_DIM,
                                        backbone="simple_cnn",
                                        generator=gen)[0]
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        ckpt = models / cfg.name / f"fold_{fold}_best{suffix}"
        save_checkpoint(ckpt, model.state_dict(), model_name=cfg.name)
        save_fold_meta(ckpt, model=cfg.name, backbone="simple_cnn",
                       image_shape=list(IMAGE), rna_dim=RNA_DIM,
                       use_pallas_resample=True, resample_mode="device")
    return dict(root=root, table=table, paths=paths, models=models, cfg=cfg)


@pytest.mark.parametrize("which", [["--ensemble"], ["--fold", "2"]],
                         ids=["ensemble", "fold2"])
def test_km_curves_then_evaluate_model_end_to_end(scored_cohort, which,
                                                  tmp_path, caplog):
    env = scored_cohort
    with caplog.at_level("INFO"):
        out = generate_km_curves.main([
            "--model", "partial_modality", "--models-dir", str(env["models"]),
            "--data-root", str(env["root"]), "--results-root",
            str(tmp_path), *which, "--device", "cpu"])
    label = "ensemble" if which == ["--ensemble"] else "fold2"
    assert (tmp_path / "km_curves"
            / f"partial_modality_{label}_km.png").exists()
    assert "skipped" not in caplog.text
    ckpts = fold_checkpoints(env["models"], "partial_modality")
    want = predict_risk(env["cfg"], ckpts if which == ["--ensemble"]
                        else ckpts[1], env["table"],
                        rnaseq_csv=env["paths"]["rnaseq_csv"], device="cpu")
    pred = evaluate.read_predictions_csv(out["predictions"])
    assert list(pred["patient_id"]) == list(want["patient_id"])
    np.testing.assert_array_equal(pred["risk_score"],
                                  want["risk_score"].astype(np.float64))

    summary = evaluate_model.main([
        "--predictions", str(tmp_path / "test_predictions.csv"),
        "--results-root", str(tmp_path)])
    written = json.loads((tmp_path / "evaluation" /
                          "evaluation_summary.json").read_text())
    jeval.evaluate_predictions(
        pd.read_csv(tmp_path / "test_predictions.csv"),
        out_dir=tmp_path / "jax")
    _assert_json_close(written, json.loads(
        (tmp_path / "jax" / "evaluation_summary.json").read_text()))
    assert abs(written["c_index"] - concordance_index_np(
        pred["risk_score"], pred["survival_time"], pred["event"])) <= TOL
    assert summary["n_patients"] == len(pred["risk_score"])
    for v in (written["logrank"]["statistic"], written["logrank"]["p_value"],
              written["c_index"]):
        assert v is not None and math.isfinite(v)


def test_calibrate_writes_predict_risk_fold_stats(scored_cohort, tmp_path):
    env = scored_cohort
    out = tmp_path / "calibration.json"
    calibrate.main(["--model", "partial_modality", "--models-dir",
                    str(env["models"]), "--data-root", str(env["root"]),
                    "--out", str(out), "--device", "cpu"])
    cal = json.loads(out.read_text())
    ckpts = fold_checkpoints(env["models"], "partial_modality")
    _, stats = predict_risk(env["cfg"], ckpts, env["table"],
                            rnaseq_csv=env["paths"]["rnaseq_csv"],
                            return_fold_stats=True, device="cpu")
    assert cal["model"] == "partial_modality"
    assert cal["checkpoints"] == [str(c) for c in ckpts]
    assert [tuple(s) for s in cal["stats"]] == [tuple(s) for s in stats]


def test_entry_points_need_the_card_unless_told_cpu(scored_cohort, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a machine with CUDA runs these on the card")
    env = scored_cohort
    for main, argv in (
            (generate_km_curves.main,
             ["--models-dir", str(env["models"]), "--data-root",
              str(env["root"]), "--results-root", str(tmp_path)]),
            (calibrate.main,
             ["--models-dir", str(env["models"]), "--data-root",
              str(env["root"]), "--out", str(tmp_path / "c.json")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


# ---------------------------------------------------------------------------
# RiskScorer.warmup / warmup_no_image and the server CLI
# ---------------------------------------------------------------------------

def _patients(env, n=4):
    rna = load_rnaseq_matrix(env["paths"]["rnaseq_csv"])
    out = []
    for r in env["table"]:
        p = {}
        if r["has_imaging"] and r["nifti_path"]:
            p["nifti_path"] = r["nifti_path"]
        if r["has_rnaseq"]:
            p["rnaseq"] = rna.row(r["patient_id"])
        if r["has_clinical"]:
            p["age"] = r["age"]
        if p:
            out.append(p)
    return out[:n] + [{"age": 50.0}]


def test_scorer_warms_itself_and_warmup_changes_no_risk(scored_cohort,
                                                        monkeypatch):
    env = scored_cohort
    ckpts = fold_checkpoints(env["models"], "partial_modality")
    calls = []
    per_fold = RiskScorer._per_fold

    def counted(self, host):
        calls.append("image" in host)
        return per_fold(self, host)

    monkeypatch.setattr(RiskScorer, "_per_fold", counted)
    scorer = RiskScorer("partial_modality", ckpts, batch_size=2,
                        device="cpu")
    assert calls == [True]  # the constructor ran one image batch
    assert not scorer._no_image_ready
    patients = _patients(env)
    before = [r["risk_score"] for r in scorer.score_many(patients)]
    calls.clear()
    scorer.warmup()
    scorer.warmup()
    assert calls == [True, True] and not scorer._no_image_ready
    after = [r["risk_score"] for r in scorer.score_many(patients)]
    assert after == before  # bit-identical

    scorer.warmup_no_image()
    scorer.warmup_no_image()
    assert scorer._no_image_ready
    calls.clear()
    no_image = [r["risk_score"] for r in scorer.score_many(patients)]
    # the image-less last patient now takes the device-zero route
    assert calls[-1] is False
    np.testing.assert_array_equal(no_image, before)

    warm = RiskScorer("partial_modality", ckpts, batch_size=2,
                      no_image_variant=True, device="cpu")
    assert warm._no_image_ready
    assert [r["risk_score"] for r in warm.score_many(patients)] == before


def test_image_free_family_warms_the_image_less_route(tmp_path):
    cfg = ALL_CONFIGS["rnaseq_only"]
    model = make_model_and_adapters(
        cfg, rna_dim=RNA_DIM, generator=torch.Generator().manual_seed(0))[0]
    ckpt = tmp_path / "fold_1_best.msgpack"
    save_checkpoint(ckpt, model.state_dict(), model_name=cfg.name)
    save_fold_meta(ckpt, model=cfg.name, rna_dim=RNA_DIM)
    scorer = RiskScorer("rnaseq_only", ckpt, device="cpu")
    assert scorer._no_image_ready
    x = np.random.default_rng(0).normal(size=RNA_DIM)
    first = scorer.score(rnaseq=x)["risk_score"]
    scorer.warmup()
    scorer.warmup_no_image()
    assert scorer.score(rnaseq=x)["risk_score"] == first
    model.eval()
    with torch.no_grad():
        want = float(model(torch.from_numpy(x.astype(np.float32))[None]
                           ).reshape(-1)[0])
    assert abs(first - want) <= 1e-6


def test_server_cli_flags_reach_the_scorer(monkeypatch, tmp_path, capsys):
    seen = {}

    class _Scorer:
        cfg = ALL_CONFIGS["final"]

        def __init__(self, *a, **k):
            seen.update(args=a, kwargs=k)

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    cal = tmp_path / "calibration.json"
    cal.write_text(json.dumps({"model": "final", "checkpoints": ["a", "b"],
                               "stats": [[0.5, 2.0], [-0.25, 1.5]]}))
    monkeypatch.setattr(serving, "RiskScorer", _Scorer)
    monkeypatch.setattr(serving, "make_server", lambda *a, **k: _Server())
    serving.main(["--model", "final", "--checkpoint", "a.msgpack",
                  "b.pth", "--calibration", str(cal), "--warm-no-image",
                  "--backbone", "simple_cnn", "--rna-dim", "40",
                  "--image-shape", "16,16,8", "--hu-window=-150,250",
                  "--batch-size", "3", "--device", "cpu"])
    assert seen["args"] == ("final", ["a.msgpack", "b.pth"])
    k = seen["kwargs"]
    assert k["fold_calibration"] == [(0.5, 2.0), (-0.25, 1.5)]
    assert k["no_image_variant"] is True
    assert k["backbone"] == "simple_cnn" and k["rna_dim"] == 40
    assert k["image_shape"] == (16, 16, 8)
    assert k["hu_window"] == (-150.0, 250.0) and k["batch_size"] == 3
    assert k["aot_cache_dir"] is None and k["device"] == "cpu"
    assert "loaded and warmed" in capsys.readouterr().out


def test_server_aot_cache_still_raises(scored_cohort, tmp_path, monkeypatch,
                                       capsys):
    """``--aot-cache DIR`` (a refusal until io/aot_cache.py was ported)
    serves: the scorer loads the host engine that decodes the requests'
    CTs through the cache in DIR, and the start-up line reports it."""
    from multimodal_survival_prediction_tpu_torch.io import aot_cache

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(aot_cache, "CACHE_DIR", None)  # put back after
    monkeypatch.setattr(serving, "make_server", lambda *a, **k: _Server())
    ckpts = fold_checkpoints(scored_cohort["models"], "partial_modality")
    serving.main(["--checkpoint", str(ckpts[0]), "--aot-cache",
                  str(tmp_path / "aot"), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "loaded and warmed" in ln][0]
    assert "(aot-cache msp_native_port: " in line
    [entry] = (tmp_path / "aot").iterdir()
    assert {p.name for p in entry.iterdir()} == {"libmsp_native_port.so",
                                                 "meta.json"}
