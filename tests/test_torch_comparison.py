"""The port's model comparison, ``run_all``, profiling and debugging
utilities, on the CPU.

* ``analysis/comparison.py`` against JAX's on the same ``cv_results.json``
  files (both schemas, unequal fold counts, a single-fold model, a tie):
  ``collect_results`` equal, ``paired_t_vs_best`` and
  ``pairwise_significance`` p-values within 1e-12 (NaN where JAX has NaN),
  ``summary_statistics_csv`` byte-equal, ``SUMMARY.md`` and
  ``results.json`` equal once the timestamp (``Generated:`` line,
  ``generated`` key) is removed.
* ``analysis.final_comparison``: the artifacts, and the printed table equal
  to pandas' ``to_string`` of JAX's frame.
* ``run_all`` in process on a 28-patient synthetic cohort (the JAX
  test_run_all arguments at 1 epoch): artifacts, exit 1 naming a failed
  family, ``--full-analysis`` raising ``ImportError`` without matplotlib
  (the battery itself: tests/test_torch_analysis_scripts.py).
* ``utils/profiling.py`` (a trace on the CPU) and ``utils/debugging.py``
  against JAX's on the same trees.
"""

import json
import math
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_survival_prediction_tpu.analysis import comparison as jcmp
from multimodal_survival_prediction_tpu.data import matching_table as jmt
from multimodal_survival_prediction_tpu.io import results as jresults
from multimodal_survival_prediction_tpu.utils import debugging as jdebug
from multimodal_survival_prediction_tpu_torch import run_all
from multimodal_survival_prediction_tpu_torch.analysis import comparison
from multimodal_survival_prediction_tpu_torch.analysis import (
    final_comparison,
)
from multimodal_survival_prediction_tpu_torch.data import matching_table as tmt
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.utils import debugging
from multimodal_survival_prediction_tpu_torch.utils import profiling

P_TOL = 1e-12


@pytest.fixture(scope="module")
def results_root(tmp_path_factory):
    """cv_results.json files of six models: standard schema at 5 folds
    (two of them tied on the mean), the legacy schema, 3 folds (Welch vs
    the best) and 1 fold (no test), written by the JAX writer."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(3)

    def folds(n, centre):
        return [dict(fold=k + 1, best_c_index=float(c), best_epoch=3,
                     train_size=40, val_size=10)
                for k, c in enumerate(rng.normal(centre, 0.03, n))]

    tie = folds(5, 0.58)
    specs = {
        "rnaseq_only": ("RNASeq-Only", folds(5, 0.62), False),
        "partial_modality": ("Partial Modality (Gated)", folds(5, 0.60),
                             False),
        "image_only": (None, folds(5, 0.55), True),
        "simple_fusion": ("Simple Fusion (RNA+Image)", folds(3, 0.57),
                          False),
        "mmsurv": ("MMsurv", folds(1, 0.52), False),
        "final": ("Complete Multimodal", tie, False),
        "flexible_multimodal": ("Flexible Multimodal", list(tie), False),
    }
    for key, (name, fr, legacy) in specs.items():
        jresults.write_cv_results(
            root / key, name, fr, hyperparameters={"lr": 1e-4},
            extra=None if legacy else {"n_folds": len(fr),
                                       "dataset_size": 40 + len(fr)},
            legacy=legacy)
    return root


@pytest.fixture(scope="module")
def matching_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=20, rna_dim=32, image_shapes=((8, 12, 12),)))
    return root / "data" / "processed" / "full_matching_table.csv"


def _close(a, b, tol=P_TOL):
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol


def test_collect_results_matches_jax(results_root):
    mine = comparison.collect_results(results_root)
    ref = jcmp.collect_results(results_root)
    assert [r["key"] for r in mine] == list(ref.key)
    for r, (_, j) in zip(mine, ref.iterrows()):
        for k in ("model", "c_index_mean", "c_index_std", "fold_scores",
                  "n_folds", "hyperparameters", "raw"):
            assert r[k] == j[k], k
    assert [r["n_folds"] for r in mine].count(5) == 5
    assert comparison.collect_results(results_root, ["mmsurv", "nope"]) \
        == [dict(mine[[r["key"] for r in mine].index("mmsurv")])]


def test_t_tests_match_jax(results_root):
    rows = comparison.collect_results(results_root)
    ref = jcmp.collect_results(results_root)
    mine = comparison.paired_t_vs_best(rows)
    jref = jcmp.paired_t_vs_best(ref)
    assert [r["test"] for r in mine] == list(jref.test)
    assert {"-", "paired-t", "welch-t", "n/a"} == {r["test"] for r in mine}
    for r, p in zip(mine, jref.p_value):
        assert _close(r["p_value"], p), (r["key"], r["p_value"], p)
    models, mat = comparison.pairwise_significance(rows)
    jmat = jcmp.pairwise_significance(ref)
    assert models == list(jmat.index) == list(jmat.columns)
    np.testing.assert_allclose(mat, jmat.to_numpy(), rtol=0, atol=P_TOL)
    assert comparison.paired_t_vs_best([]) == []


@pytest.mark.parametrize("c", [0.75, 0.70, 0.66, 0.65, 0.61, 0.60, 0.56,
                               0.55, 0.50])
def test_recommendation_tier_matches_jax(c):
    assert comparison.recommendation_tier(c) == jcmp.recommendation_tier(c)


def _untimed_md(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Generated:")]


@pytest.mark.parametrize("with_table", [False, True],
                         ids=["no-table", "table"])
def test_summary_md_and_results_json_match_jax(results_root, matching_csv,
                                               tmp_path, with_table):
    rows = comparison.collect_results(results_root)
    ref = jcmp.collect_results(results_root)
    table = tmt.load_matching_table(matching_csv) if with_table else None
    jtable = jmt.load_matching_table(matching_csv) if with_table else None
    mine_md = comparison.generate_summary_md(rows, table,
                                             tmp_path / "a" / "SUMMARY.md")
    ref_md = jcmp.generate_summary_md(ref, jtable,
                                      tmp_path / "b" / "SUMMARY.md")
    assert _untimed_md(mine_md) == _untimed_md(ref_md)
    assert (tmp_path / "a" / "SUMMARY.md").read_text() == mine_md
    assert ("## Dataset" in mine_md) == with_table
    mine = comparison.export_results_json(rows, table,
                                          tmp_path / "a" / "results.json")
    jref = jcmp.export_results_json(ref, jtable,
                                    tmp_path / "b" / "results.json")
    on_disk = [json.loads((tmp_path / d / "results.json").read_text())
               for d in ("a", "b")]
    for d in (mine, jref, *on_disk):
        d.pop("generated")
    assert mine == jref == on_disk[0] == on_disk[1]
    if with_table:
        assert mine["dataset_info"] == jmt.cohort_stats(jtable)


def test_summary_statistics_csv_matches_jax(results_root, tmp_path):
    rows = comparison.collect_results(results_root)
    out = comparison.summary_statistics_csv(rows, tmp_path / "a.csv")
    ref = jcmp.summary_statistics_csv(jcmp.collect_results(results_root),
                                      tmp_path / "b.csv")
    assert (tmp_path / "a.csv").read_text() == \
        (tmp_path / "b.csv").read_text()
    assert len(out) == len(ref)


@pytest.mark.parametrize("values", [
    ([0.6174, 0.55, 0.5012345678], [math.nan, 0.0421234, 0.3]),
    ([0.5, 0.25], [math.nan, 1e-7]),
    ([0.5], [math.nan]),
    ([0.51234567891, 0.25], [0.5, 0.123456789]),
], ids=["three", "small-p", "one", "wide"])
def test_format_table_is_pandas_to_string(values):
    means, ps = values
    names = ["RNASeq-Only", "Bbbbbbbbbbbbbbbbbbbb", "Partial Modality (Gated)"]
    rows = [dict(model=names[i], c_index_mean=m, p_value=p)
            for i, (m, p) in enumerate(zip(means, ps))]
    cols = ["model", "c_index_mean", "p_value"]
    assert final_comparison.format_table(rows, cols) == \
        pd.DataFrame(rows)[cols].to_string(index=False)


def test_final_comparison_entry_point(results_root, matching_csv, tmp_path,
                                      capsys):
    data_root = matching_csv.parents[2]
    out = tmp_path / "fc"
    payload = final_comparison.main([
        "--results-root", str(results_root), "--data-root", str(data_root),
        "--out-dir", str(out)])
    printed = capsys.readouterr().out
    # the figures drawn (pixel-equal to JAX's: tests/test_torch_figures.py)
    assert (out / "model_comparison_main.png").exists()
    assert (out / "ablation_study.png").exists() and "skipped" not in printed
    ref = jcmp.paired_t_vs_best(jcmp.collect_results(results_root))
    assert ref[["model", "c_index_mean", "p_value"]].to_string(
        index=False) in printed
    md = (out / "SUMMARY.md").read_text()
    assert "## Dataset" in md and md in printed
    assert json.loads((out / "results.json").read_text()) == payload
    assert payload["best_model"] == "RNASeq-Only"
    assert final_comparison.main(["--results-root", str(tmp_path / "none"),
                                  "--out-dir", str(out)]) is None


# ---------------------------------------------------------------------------
# run_all
# ---------------------------------------------------------------------------

RUN_ALL_ARGS = ["--synthetic", "--synthetic-patients", "28", "--epochs",
                "1", "--n-folds", "2", "--image-shape", "12,12,8",
                "--backbone", "simple_cnn", "--device", "cpu"]


def _dirs(tmp_path):
    return ["--data-root", str(tmp_path / "cohort"), "--results-dir",
            str(tmp_path / "results"), "--models-dir",
            str(tmp_path / "models")]


def test_run_all_trains_and_compares(tmp_path, capsys):
    """The JAX test_run_all arguments at 1 epoch, in process: both
    families' cv_results.json (2 folds each), then SUMMARY.md and
    results.json whose means are the payloads'."""
    failed = run_all.main(["--models", "rnaseq_only,image_only",
                           *_dirs(tmp_path), *RUN_ALL_ARGS])
    assert failed == []
    res = tmp_path / "results"
    means = {}
    for model in ("rnaseq_only", "image_only"):
        payload = json.loads((res / model / "cv_results.json").read_text())
        assert len(payload["fold_results"]) == 2
        means[model] = payload["c_index_mean"]
    summary = json.loads((res / "final_comparison" / "results.json")
                         .read_text())
    got = {m["model"]: m["c_index_mean"] for m in summary["models"]}
    assert got == {"RNASeq-Only": means["rnaseq_only"],
                   # image_only writes the legacy schema: named by its dir
                   "image_only": means["image_only"]}
    md = (res / "final_comparison" / "SUMMARY.md").read_text()
    assert md in capsys.readouterr().out
    assert f"{means['rnaseq_only']:.4f}" in md
    assert list((tmp_path / "models" / "rnaseq_only").glob("fold_*_best.pt"))


def test_run_all_exits_1_naming_a_failed_family(tmp_path, monkeypatch,
                                                capsys):
    real = run_all.run_training

    def flaky(args, cfg):
        if cfg.name == "image_only":
            raise RuntimeError("no CT decoded")
        return real(args, cfg)

    monkeypatch.setattr(run_all, "run_training", flaky)
    with pytest.raises(SystemExit) as exc:
        run_all.main(["--models", "rnaseq_only,image_only",
                      *_dirs(tmp_path), *RUN_ALL_ARGS])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "image_only FAILED: no CT decoded" in out
    assert "1 step(s) FAILED: train:image_only" in out
    # the families that trained are still compared
    assert (tmp_path / "results" / "final_comparison" / "SUMMARY.md").exists()


def test_run_all_full_analysis_raises_with_its_item(tmp_path, monkeypatch):
    """Without matplotlib (the card's machine) ``--full-analysis``, whose
    battery draws, raises ``ImportError`` naming it before any training."""
    from multimodal_survival_prediction_tpu_torch import analysis

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, f"{analysis.__name__}.figures",
                        raising=False)
    monkeypatch.delattr(analysis, "figures", raising=False)
    with pytest.raises(ImportError, match="matplotlib") as exc:
        run_all.main(["--models", "rnaseq_only", "--full-analysis",
                      *_dirs(tmp_path), *RUN_ALL_ARGS])
    assert exc.value.name == "matplotlib"
    assert not (tmp_path / "results").exists()
    assert not (tmp_path / "cohort").exists()


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_profile_trace_writes_a_trace_on_cpu(tmp_path):
    with profiling.profile_trace(tmp_path / "prof"):
        x = torch.randn(16, 16)
        (x @ x).relu().sum()
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert {"aten::matmul", "aten::relu"} <= names


def test_block_and_time_and_throughput_meter():
    calls = []

    def fn(x, scale=1.0):
        calls.append(scale)
        return {"y": [x * scale]}

    sec, out = profiling.block_and_time(fn, torch.ones(3), iters=3,
                                        scale=2.0)
    assert sec >= 0 and calls == [2.0] * 4
    torch.testing.assert_close(out["y"][0], torch.full((3,), 2.0))
    meter = profiling.ThroughputMeter("t")
    for _ in range(3):
        meter.update(8)
    s = meter.summary()
    assert (s["name"], s["steps"], s["items"]) == ("t", 3, 24)
    meter.reset()
    assert meter.steps == meter.items == 0


def _tree(bad=None):
    tree = {"encoder": {"w": np.ones((3, 4), np.float32),
                        "b": np.zeros(4, np.float32)},
            "head": [np.arange(5, dtype=np.float32), np.int32(7)]}
    if bad is not None:
        tree["encoder"]["b"][1] = bad
        tree["head"][0][2] = bad
    return tree


@pytest.mark.parametrize("bad", [None, np.nan, np.inf],
                         ids=["finite", "nan", "inf"])
def test_check_finite_and_param_count_match_jax(bad):
    tree = _tree(bad)
    ttree = {"encoder": {k: torch.from_numpy(v)
                         for k, v in tree["encoder"].items()},
             "head": [torch.from_numpy(tree["head"][0]), tree["head"][1]]}
    # 12 + 4 + 5, and the 0-d array counts one as in JAX
    assert debugging.param_count(tree) == jdebug.param_count(tree) == 22
    assert debugging.param_count(ttree) == 22
    if bad is None:
        debugging.check_finite(tree)
        debugging.check_finite(ttree)
        jdebug.check_finite(tree)
        return
    with pytest.raises(FloatingPointError) as ref:
        jdebug.check_finite(tree, "params")
    for t in (tree, ttree):
        with pytest.raises(FloatingPointError) as mine:
            debugging.check_finite(t, "params")
        assert str(mine.value) == str(ref.value)


def test_state_dict_checks_and_nan_guard():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                                torch.nn.Linear(3, 1))
    assert debugging.param_count(model) == 4 * 3 + 3 + 3 + 1
    debugging.check_finite(model.state_dict(), "model")
    with torch.no_grad():
        model[2].bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match=r"\['2.bias'\]"):
        debugging.check_finite(model.state_dict(), "model")
    x = torch.ones(3)
    assert debugging.nan_guard(x, "ok") is x
    with pytest.raises(FloatingPointError, match="at logits"):
        debugging.nan_guard(torch.tensor([1.0, float("inf")]), "logits")
    with pytest.raises(FloatingPointError, match="at host"):
        debugging.nan_guard(np.array([np.nan]), "host")
