"""The port's drawing entry points against the JAX scripts on the CPU:
``analysis.analyze_all_results``, ``analysis.comprehensive_analysis`` and
``analysis.create_report_figures`` against ``scripts/analysis/*.py`` (run
in process) on the same ``cv_results.json`` files and cohort: the same
printed lines, the same files, text byte for byte and PNGs pixel for
pixel; then ``run_all --full-analysis``, the whole battery after training,
with a failed step recorded while the rest run on.
"""

import runpy
import sys
from pathlib import Path

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest

from multimodal_survival_prediction_tpu.io import results as jresults
from multimodal_survival_prediction_tpu_torch import run_all
from multimodal_survival_prediction_tpu_torch.analysis import (
    analyze_all_results,
    comprehensive_analysis,
    create_report_figures,
    final_comparison,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts" / "analysis"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A cohort (imaging patients' NIfTIs, the matching table) and the
    cv_results.json of six models by the JAX writer: both schemas, unequal
    fold counts, one fold, a NaN-free and a baseline-free mix."""
    root = tmp_path_factory.mktemp("tree")
    generate_synthetic_cohort(root / "cohort", SyntheticCohortSpec(
        n_patients=20, rna_dim=32, p_imaging=0.5,
        image_shapes=((8, 12, 12), (6, 10, 10))))
    rng = np.random.default_rng(11)
    specs = {
        "rnaseq_only": ("RNASeq-Only", 5, 0.62, True),
        "partial_modality": ("Partial Modality (Gated)", 5, 0.60, True),
        "image_only": (None, 5, 0.55, False),
        "simple_fusion": ("Simple Fusion (RNA+Image)", 3, 0.57, True),
        "simmim": ("SimMLM", 5, 0.59, True),
        "mmsurv": ("MMsurv", 1, 0.52, True),
    }
    for key, (name, n, centre, standard) in specs.items():
        fr = [dict(fold=k + 1, best_c_index=float(c), best_epoch=2,
                   train_size=40, val_size=10)
              for k, c in enumerate(rng.normal(centre, 0.04, n))]
        jresults.write_cv_results(
            root / "results" / key, name, fr, hyperparameters={"lr": 1e-4},
            extra={"n_folds": n, "dataset_size": 40 + 10 * n}
            if standard else None, legacy=not standard)
    return root


def _run_jax_script(name, argv, monkeypatch):
    """``scripts/analysis/<name>`` as ``__main__`` in this process (its
    ``common`` module is the analysis scripts', whatever another test
    imported under that name)."""
    saved = sys.modules.pop("common", None)
    try:
        with monkeypatch.context() as m:
            m.syspath_prepend(str(SCRIPTS))
            m.setattr(sys, "argv", [name, *argv])
            runpy.run_path(str(SCRIPTS / name), run_name="__main__")
    finally:
        sys.modules.pop("common", None)
        if saved is not None:
            sys.modules["common"] = saved


def _same_tree(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert files
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(plt.imread(a / rel), plt.imread(b / rel)), \
                rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return [str(f) for f in files]


ENTRY_POINTS = {
    "analyze_all_results.py": analyze_all_results,
    "comprehensive_analysis.py": comprehensive_analysis,
    "create_report_figures.py": create_report_figures,
}


@pytest.mark.parametrize("script", sorted(ENTRY_POINTS))
def test_entry_point_matches_the_jax_script(script, tree, tmp_path,
                                            monkeypatch, capsys):
    module = ENTRY_POINTS[script]
    common = ["--results-root", str(tree / "results"),
              "--data-root", str(tree / "cohort")]
    module.main([*common, "--out-dir", str(tmp_path / "port")])
    mine = capsys.readouterr().out
    _run_jax_script(script, [*common, "--out-dir", str(tmp_path / "jax")],
                    monkeypatch)
    ref = capsys.readouterr().out
    assert mine.replace(str(tmp_path / "port"), "OUT") == \
        ref.replace(str(tmp_path / "jax"), "OUT")
    files = _same_tree(tmp_path / "port", tmp_path / "jax")
    if script == "analyze_all_results.py":
        assert files == ["analysis_report.txt",
                         "model_comparison_analysis.png"]
        assert "Pairwise p-values:" in mine and "NaN" in mine
    elif script == "comprehensive_analysis.py":
        assert "significance_heatmap.png" in files
        assert "summary_statistics.csv" in files
    else:
        assert files == ["cohort_km.png", "modality_availability.png",
                         "model_comparison.png", "sample_ct_slices.png"]


def test_report_pivot_and_pvalues_are_pandas(tree):
    """The report's two frames are pandas' ``to_string`` of JAX's."""
    from multimodal_survival_prediction_tpu.analysis import comparison as jc
    from multimodal_survival_prediction_tpu_torch.analysis import comparison

    rows = comparison.collect_results(tree / "results")
    df = jc.collect_results(tree / "results")
    pivot = pd.DataFrame({r.model: pd.Series(r.fold_scores)
                          for _, r in df.iterrows()})
    assert analyze_all_results.fold_pivot(rows) == pivot.to_string()
    lines = analyze_all_results.report_lines(rows)
    assert jc.pairwise_significance(df).round(4).to_string() in \
        "\n".join(lines)
    assert final_comparison.format_frame(
        {"x": [0.5, -0.25]}, ["a", "b"]) == \
        pd.DataFrame({"x": [0.5, -0.25]}, index=["a", "b"]).to_string()


RUN_ALL_ARGS = ["--synthetic", "--synthetic-patients", "28", "--epochs",
                "1", "--n-folds", "2", "--image-shape", "12,12,8",
                "--backbone", "simple_cnn", "--device", "cpu"]


def test_run_all_full_analysis_runs_the_battery(tmp_path, monkeypatch,
                                                capsys):
    """Two families, then every analysis step in JAX's order; the KM step
    scores the flagship's .pt folds; a step that fails is recorded (exit
    1 naming it) and the later steps still run."""
    def broken(argv):
        raise RuntimeError("disk full")

    monkeypatch.setattr(comprehensive_analysis, "main", broken)
    res = tmp_path / "results"
    with pytest.raises(SystemExit) as exc:
        run_all.main(["--models", "rnaseq_only,partial_modality",
                      "--full-analysis", "--data-root",
                      str(tmp_path / "cohort"), "--results-dir", str(res),
                      "--models-dir", str(tmp_path / "models"),
                      *RUN_ALL_ARGS])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    steps = [ln[4:] for ln in out.splitlines() if ln.startswith("--- ")]
    assert steps == ["analyze_all_results", "comprehensive_analysis",
                     "final_comparison", "create_report_figures",
                     "generate_km_curves", "evaluate_model"]
    assert "1 step(s) FAILED: analysis:comprehensive_analysis" in out
    for rel in ("analysis_report.txt", "model_comparison_analysis.png",
                "final_comparison/model_comparison_main.png",
                "final_comparison/ablation_study.png",
                "report_figures/modality_availability.png",
                "km_curves/partial_modality_ensemble_km.png",
                "test_predictions.csv",
                "evaluation/evaluation_summary.json",
                "evaluation/kaplan_meier_curves.png",
                "evaluation/risk_distributions.png"):
        assert (res / rel).exists(), rel
    assert not (res / "comprehensive_analysis").exists()
