"""Fold-ensemble calibration for the server (port of
``scripts/serving/calibrate.py``).

Scores the cohort with every fold checkpoint and writes the per-fold
(mu, sd) of the log-hazards, the pairs that ``RiskScorer(fold_calibration=)``
and the server's ``--calibration`` take, so a single request's ensemble
score matches ``predict_risk``'s cohort-level z-scored combination:

    python -m multimodal_survival_prediction_tpu_torch.tools.calibrate \\
        --model partial_modality --models-dir models --data-root . \\
        --out calibration.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import ALL_CONFIGS
from ..data.matching_table import load_matching_table
from ..train.predict import fold_checkpoints, predict_risk


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="partial_modality",
                   choices=sorted(ALL_CONFIGS))
    p.add_argument("--models-dir", default="models")
    p.add_argument("--data-root", default=".")
    p.add_argument("--out", default=None,
                   help="default: <models-dir>/<model>/calibration.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = ALL_CONFIGS[args.model]
    root = Path(args.data_root)
    table = load_matching_table(
        root / "data" / "processed" / "full_matching_table.csv")
    rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"
    if not rnaseq_csv.exists():
        rnaseq_csv = None
    ckpts = fold_checkpoints(args.models_dir, cfg.name)
    _, stats = predict_risk(cfg, ckpts, table, rnaseq_csv=rnaseq_csv,
                            return_fold_stats=True, device=args.device)

    out = Path(args.out or Path(args.models_dir) / cfg.name
               / "calibration.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    payload = {"model": cfg.name, "checkpoints": [str(c) for c in ckpts],
               "stats": stats}  # [(mu, sd), ...] fold-ordered
    out.write_text(json.dumps(payload, indent=2))
    print(f"calibration for {len(ckpts)} folds -> {out}")
    for k, (mu, sd) in enumerate(stats, 1):
        print(f"  fold {k}: mu={mu:+.4f} sd={sd:.4f}")
    return payload


if __name__ == "__main__":
    main()
