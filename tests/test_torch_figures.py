"""``analysis/figures.py`` of the port against the JAX package's on the CPU:
each of the twelve drawing functions fed the same numpy data (a DataFrame
to JAX, the port's rows and columns to the port), the two PNGs decoded and
held pixel for pixel; then the port without matplotlib (every other module
imports, the entry points write their tables and log the one line that
names the missing matplotlib).
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest

from multimodal_survival_prediction_tpu.analysis import comparison as jcmp
from multimodal_survival_prediction_tpu.analysis import figures as jfig
from multimodal_survival_prediction_tpu.analysis.evaluate import (
    km_event_types as jkm_event_types,
)
from multimodal_survival_prediction_tpu.data import matching_table as jmt
from multimodal_survival_prediction_tpu.io import results as jresults
from multimodal_survival_prediction_tpu.ops import km as jkm
from multimodal_survival_prediction_tpu_torch.analysis import comparison
from multimodal_survival_prediction_tpu_torch.analysis import evaluate
from multimodal_survival_prediction_tpu_torch.analysis import figures
from multimodal_survival_prediction_tpu_torch.data import matching_table as tmt
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.ops import km

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def results_root(tmp_path_factory):
    """cv_results.json of five models by the JAX writer: both schemas,
    unequal fold counts, the Image-Only baseline, one model without a
    dataset size."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(5)
    specs = {
        "rnaseq_only": ("RNASeq-Only", 5, 0.62, True),
        "partial_modality": ("Partial Modality (Gated)", 5, 0.60, True),
        "image_only": (None, 5, 0.55, False),
        "simple_fusion": ("Simple Fusion (RNA+Image)", 3, 0.57, True),
        "mmsurv": ("MMsurv", 2, 0.52, True),
    }
    for key, (name, n, centre, standard) in specs.items():
        fr = [dict(fold=k + 1, best_c_index=float(c), best_epoch=2,
                   train_size=40, val_size=10)
              for k, c in enumerate(rng.normal(centre, 0.03, n))]
        jresults.write_cv_results(
            root / key, name, fr, hyperparameters={"lr": 1e-4},
            extra={"n_folds": n, "dataset_size": 40 + 10 * n}
            if standard else None, legacy=not standard)
    return root


@pytest.fixture(scope="module")
def cohort_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=24, rna_dim=32, image_shapes=((8, 12, 12),)))
    return root / "data" / "processed" / "full_matching_table.csv"


def _pred(n=40, seed=9):
    rng = np.random.default_rng(seed)
    return {"patient_id": np.asarray([f"P{i:02d}" for i in range(n)],
                                     dtype=object),
            "risk_score": rng.normal(size=n),
            "survival_time": rng.exponential(500.0, n),
            "event": (rng.uniform(size=n) < 0.6).astype(np.int64)}


def _curves(pred, module):
    risk, t, e = (np.asarray(pred[k], np.float64)
                  for k in ("risk_score", "survival_time", "event"))
    hi = risk > np.median(risk)
    return {"high risk": module.kaplan_meier(t[hi], e[hi]),
            "low risk": module.kaplan_meier(t[~hi], e[~hi])}


def _cases(results_root, cohort_csv):
    """name -> (JAX call, port call), each taking the output path."""
    df = jcmp.collect_results(results_root)
    rows = comparison.collect_results(results_root)
    pred = _pred()
    jpred = pd.DataFrame(pred)
    jcurves, curves = _curves(pred, jkm), _curves(pred, km)
    vols = [np.random.default_rng(s).normal(size=(6, 10, 12)).astype(
        np.float32) for s in range(3)]
    jtable = jmt.load_matching_table(cohort_csv)
    table = tmt.load_matching_table(cohort_csv)
    return {
        "model_comparison_main": (
            lambda o: jfig.model_comparison_main(df, o),
            lambda o: figures.model_comparison_main(rows, o)),
        "ablation_study": (lambda o: jfig.ablation_study(df, o),
                           lambda o: figures.ablation_study(rows, o)),
        "significance_heatmap": (
            lambda o: jfig.significance_heatmap(
                jcmp.pairwise_significance(df), o),
            lambda o: figures.significance_heatmap(
                comparison.pairwise_significance(rows), o)),
        "foldwise_bars": (lambda o: jfig.foldwise_bars(df, o),
                          lambda o: figures.foldwise_bars(rows, o)),
        "violin_scatter": (lambda o: jfig.violin_scatter(df, o),
                           lambda o: figures.violin_scatter(rows, o)),
        "performance_vs_dataset_size": (
            lambda o: jfig.performance_vs_dataset_size(df, o),
            lambda o: figures.performance_vs_dataset_size(rows, o)),
        "model_comparison_analysis": (
            lambda o: jfig.model_comparison_analysis(df, o),
            lambda o: figures.model_comparison_analysis(rows, o)),
        "km_plot": (
            lambda o: jfig.km_plot(jcurves, o, title="KM", pvalue=0.0123),
            lambda o: figures.km_plot(curves, o, title="KM", pvalue=0.0123)),
        "kaplan_meier_panels": (
            lambda o: jfig.kaplan_meier_panels(
                jcurves, jkm_event_types(jpred), o, pvalue=0.5),
            lambda o: figures.kaplan_meier_panels(
                curves, evaluate.km_event_types(pred), o, pvalue=0.5)),
        "modality_availability": (
            lambda o: jfig.modality_availability(jtable, o),
            lambda o: figures.modality_availability(table, o)),
        "ct_slice_gallery": (
            lambda o: jfig.ct_slice_gallery(vols, o, ["a", "b", "c"]),
            lambda o: figures.ct_slice_gallery(vols, o, ["a", "b", "c"])),
        "risk_distributions": (
            lambda o: jfig.risk_distributions(jpred, o),
            lambda o: figures.risk_distributions(pred, o)),
    }


NAMES = ["model_comparison_main", "ablation_study", "significance_heatmap",
         "foldwise_bars", "violin_scatter", "performance_vs_dataset_size",
         "model_comparison_analysis", "km_plot", "kaplan_meier_panels",
         "modality_availability", "ct_slice_gallery", "risk_distributions"]


@pytest.mark.parametrize("name", NAMES)
def test_figure_pixels_equal_jax(name, results_root, cohort_csv, tmp_path):
    ref, mine = _cases(results_root, cohort_csv)[name]
    a, b = tmp_path / "jax" / f"{name}.png", tmp_path / "port" / f"{name}.png"
    assert ref(a) == a and mine(b) == b
    pa, pb = plt.imread(a), plt.imread(b)
    assert pa.shape == pb.shape and pa.shape[0] > 100
    assert np.array_equal(pa, pb)
    assert pb[..., :3].min() < 0.5 < pb[..., :3].max()  # something drawn


def test_the_port_runs_without_matplotlib(results_root, tmp_path):
    """In a fresh interpreter with ``sys.modules["matplotlib"] = None``
    (the card's machine): every port module but ``analysis/figures.py``
    imports, figures.py raises ``ImportError`` naming matplotlib,
    ``final_comparison`` and ``comprehensive_analysis`` still write their
    tables and log one line naming matplotlib, and ``create_report_figures``
    (figures only) logs it too and writes nothing."""
    code = f"""
import importlib, json, logging, pkgutil, sys
sys.modules["matplotlib"] = None
logging.basicConfig(level=logging.WARNING, format="%(message)s")
import multimodal_survival_prediction_tpu_torch as p
fig = p.__name__ + ".analysis.figures"
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for m in mods:
    if m != fig:
        importlib.import_module(m)
try:
    importlib.import_module(fig)
    refused = None
except ImportError as e:
    refused = e.name
from multimodal_survival_prediction_tpu_torch.analysis import (
    comprehensive_analysis, create_report_figures, final_comparison)
final_comparison.main(["--results-root", {str(results_root)!r},
                       "--out-dir", {str(tmp_path / "fc")!r}])
comprehensive_analysis.main(["--results-root", {str(results_root)!r},
                             "--out-dir", {str(tmp_path / "ca")!r}])
create_report_figures.main(["--results-root", {str(results_root)!r},
                            "--data-root", {str(results_root)!r},
                            "--out-dir", {str(tmp_path / "rf")!r}])
print(json.dumps({{"n": len(mods), "refused": refused}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["refused"] == "matplotlib" and out["n"] > 60
    skips = [ln for ln in proc.stderr.splitlines()
             if "skipped: matplotlib is not installed" in ln]
    assert len(skips) == 2
    assert "model_comparison_main.png" in skips[0]
    assert sorted(p.name for p in (tmp_path / "fc").iterdir()) == \
        ["SUMMARY.md", "results.json"]
    assert [p.name for p in (tmp_path / "ca").iterdir()] == \
        ["summary_statistics.csv"]
    assert "no matching table found" in proc.stdout
    assert not (tmp_path / "rf").exists()
    assert math.isfinite(json.loads(
        (tmp_path / "fc" / "results.json").read_text())["models"][0][
            "c_index_mean"])
