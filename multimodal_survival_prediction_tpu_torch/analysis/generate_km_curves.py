"""Kaplan-Meier risk groups from trained fold checkpoints (port of
``scripts/analysis/generate_km_curves.py``).

Rebuilds the model, loads ``--fold``'s checkpoint (or every fold's with
``--ensemble``; any format of ``io/checkpoint.py``), scores the labelled
cohort with ``train.predict.predict_risk``, splits it at the median risk,
fits a KM curve to each group with a log-rank test, and writes the
predictions CSV that ``analysis.evaluate_model`` reads:

    python -m multimodal_survival_prediction_tpu_torch.analysis.generate_km_curves \\
        --model partial_modality --models-dir models --data-root . --ensemble

The KM figure ``<model>_<fold|ensemble>_km.png`` needs matplotlib;
without it one line says it was skipped.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..config import ALL_CONFIGS
from ..data.matching_table import load_matching_table
from ..train.predict import fold_checkpoint, fold_checkpoints, predict_risk
from ..utils import parse_hu_window
from . import load_figures
from .evaluate import km_groups, write_predictions_csv



def base_parser(desc: str) -> argparse.ArgumentParser:
    """The flags of ``scripts/analysis/common.py:base_parser``."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--results-root", default="results")
    p.add_argument("--data-root", default=".",
                   help="root containing data/processed/full_matching_table.csv")
    p.add_argument("--out-dir", default=None)
    return p


def main(argv=None) -> dict:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--model", default="partial_modality",
                   choices=sorted(ALL_CONFIGS))
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--ensemble", action="store_true",
                   help="score with ALL fold checkpoints (per-fold z-scored "
                        "log-hazards averaged) instead of --fold's one")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--backbone", default=None,
                   choices=["densenet121", "simple_cnn", "swin_vit"],
                   help="default: the checkpoint's .meta.json, else "
                        "densenet121")
    p.add_argument("--pallas-resample", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="force the CT W-pass kernel on/off; default: follow "
                        "the checkpoint's .meta.json")
    p.add_argument("--hu-window", default=None,
                   help="CT Hounsfield window 'lo,hi', as the checkpoint was "
                        "trained (the = form for negative bounds)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = ALL_CONFIGS[args.model]
    root = Path(args.data_root)
    table = load_matching_table(
        root / "data" / "processed" / "full_matching_table.csv")
    rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"
    if args.ensemble:
        ckpt = fold_checkpoints(args.models_dir, cfg.name)
        label = "ensemble"
        title = f"{cfg.display_name} fold ensemble ({len(ckpt)} folds)"
    else:
        ckpt = fold_checkpoint(args.models_dir, cfg.name, args.fold)
        label = f"fold{args.fold}"
        title = f"{cfg.display_name} fold {args.fold}"

    pred = predict_risk(cfg, ckpt, table, rnaseq_csv=rnaseq_csv,
                        backbone=args.backbone,
                        use_pallas=args.pallas_resample,
                        hu_window=parse_hu_window(args.hu_window),
                        device=args.device)
    hi, lo, lr = km_groups(pred)
    out_dir = Path(args.out_dir or Path(args.results_root) / "km_curves")
    figures = load_figures(f"{cfg.name}_{label}_km.png")
    if figures is not None:
        figures.km_plot({"high risk": hi, "low risk": lo},
                        out_dir / f"{cfg.name}_{label}_km.png", title=title,
                        pvalue=lr.p_value)
    csv_path = out_dir / f"{cfg.name}_{label}_predictions.csv"
    write_predictions_csv(csv_path, pred)
    # the contract analysis.evaluate_model reads (reference evaluate_model.py)
    write_predictions_csv(Path(args.results_root) / "test_predictions.csv",
                          pred)
    print(f"{len(pred['risk_score'])} patients; high risk {hi.at_risk[0]} "
          f"(median survival {hi.median_survival_time}), low risk "
          f"{lo.at_risk[0]} (median survival {lo.median_survival_time}); "
          f"log-rank p={lr.p_value:.4g}; predictions -> {csv_path}")
    return {"predictions": csv_path, "km_high": hi, "km_low": lo,
            "logrank": lr}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
