"""Train every model family end-to-end and write the comparison — the
reference's training phase and its SUMMARY.md as one command (the port's
counterpart of ``scripts/run_all.py``):

    python -m multimodal_survival_prediction_tpu_torch.run_all --synthetic \\
        --data-root /tmp/cohort --epochs 5 \\
        --models rnaseq_only,image_only,partial_modality

It takes the training CLI's flags (``train/cli.py``) plus ``--models``,
trains each family in process through ``train.cli.run_training``, then
writes ``<results-dir>/final_comparison/SUMMARY.md`` and ``results.json``.
``--full-analysis`` then runs the JAX script's analysis battery over the
fresh results, each step an entry point of ``analysis/`` called in
process: ``analyze_all_results``, ``comprehensive_analysis``,
``final_comparison``, ``create_report_figures``, then, for the flagship
where it was trained (else the first selected family with fold
checkpoints, in any format), ``generate_km_curves --ensemble`` and
``evaluate_model``. The battery draws figures: without matplotlib
``--full-analysis`` raises ``ImportError`` before any training.
A failed family or step is logged and the run goes on; the process then
exits 1 naming every failed step.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from .analysis.comparison import (
    collect_results,
    export_results_json,
    generate_summary_md,
)
from .config import ALL_CONFIGS
from .train.cli import base_parser, run_training
from .train.predict import fold_checkpoints

log = logging.getLogger(__name__)

DEFAULT_MODELS = ("rnaseq_only", "image_only", "simple_fusion",
                  "flexible_multimodal", "final", "partial_modality",
                  "simmim", "mmsurv")


def main(argv=None) -> list:
    """Returns the failed steps (empty when every step passed); exits 1
    when there are any, as the JAX script does."""
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--models", default=",".join(DEFAULT_MODELS))
    p.add_argument("--full-analysis", action="store_true",
                   help="after training, run the ENTIRE analysis battery "
                        "(analyze_all_results, comprehensive_analysis, "
                        "final_comparison, report figures, ensemble KM "
                        "curves + evaluation) over the fresh results")
    args = p.parse_args(argv)
    if args.full_analysis:
        try:
            from .analysis import figures  # noqa: F401 (imports matplotlib)
        except ImportError as e:
            raise ImportError(
                "--full-analysis draws figures with matplotlib, which does "
                f"not import here ({e}); run without it for the tables",
                name="matplotlib") from e

    failed: list[str] = []
    for name in args.models.split(","):
        name = name.strip()
        cfg = ALL_CONFIGS[name]
        print(f"\n{'=' * 60}\nTraining {cfg.display_name}\n{'=' * 60}")
        try:
            run_training(args, cfg)
        except Exception as e:  # one family's failure is reported, not fatal
            log.exception("%s failed", name)
            print(f"{name} FAILED: {e}")
            failed.append(f"train:{name}")

    rows = collect_results(args.results_dir)
    if rows:
        out = Path(args.results_dir) / "final_comparison"
        md = generate_summary_md(rows, None, out / "SUMMARY.md")
        export_results_json(rows, None, out / "results.json")
        print(md)

    if args.full_analysis:
        failed += analysis_battery(args)

    # scripted callers detect a broken phase by the exit code
    if failed:
        print(f"\nrun_all: {len(failed)} step(s) FAILED: {', '.join(failed)}")
        sys.exit(1)
    return failed


def _has_folds(models_dir, name: str) -> bool:
    try:
        return bool(fold_checkpoints(models_dir, name))
    except FileNotFoundError:
        return False


def analysis_battery(args) -> list:
    """The ``--full-analysis`` steps (JAX ``scripts/run_all.py:60-100``),
    each entry point's ``main(argv)``; returns the failed ones."""
    from .analysis import (
        analyze_all_results,
        comprehensive_analysis,
        create_report_figures,
        evaluate_model,
        final_comparison,
        generate_km_curves,
    )

    common = ["--results-root", str(args.results_dir),
              "--data-root", str(args.data_root)]
    # KM/evaluation need fold checkpoints: use the flagship when it was
    # trained this run, else the first selected model that has them
    trained = [m.strip() for m in args.models.split(",")]
    km_model = next((m for m in (["partial_modality"] + trained)
                     if m in trained and _has_folds(args.models_dir, m)),
                    None)
    steps = [(analyze_all_results, common),
             (comprehensive_analysis, common),
             (final_comparison, common),
             (create_report_figures, common)]
    if km_model is not None:
        km = ["--model", km_model, "--ensemble", "--models-dir",
              str(args.models_dir), "--device", args.device]
        if args.hu_window:
            km += [f"--hu-window={args.hu_window}"]
        steps += [
            (generate_km_curves, [*common, *km]),
            (evaluate_model, [*common, "--predictions",
                              str(Path(args.results_dir)
                                  / "test_predictions.csv"),
                              "--out-dir",
                              str(Path(args.results_dir) / "evaluation")]),
        ]
    else:
        print("skipping KM curves + evaluation: no fold checkpoints "
              "for any selected model under", args.models_dir)
    failed = []
    for module, argv in steps:
        name = module.__name__.rsplit(".", 1)[-1]
        print(f"\n--- {name}")
        try:
            module.main(argv)
        except (Exception, SystemExit) as e:  # recorded, the battery goes on
            log.exception("%s failed", name)
            print(f"{name} FAILED ({e!r})")
            failed.append(f"analysis:{name}")
    return failed


if __name__ == "__main__":
    main()
