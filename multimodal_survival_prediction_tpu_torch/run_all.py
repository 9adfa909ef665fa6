"""Train every model family end-to-end and write the comparison — the
reference's training phase and its SUMMARY.md as one command (the port's
counterpart of ``scripts/run_all.py``):

    python -m multimodal_survival_prediction_tpu_torch.run_all --synthetic \\
        --data-root /tmp/cohort --epochs 5 \\
        --models rnaseq_only,image_only,partial_modality

It takes the training CLI's flags (``train/cli.py``) plus ``--models``,
trains each family in process through ``train.cli.run_training``, then
writes ``<results-dir>/final_comparison/SUMMARY.md`` and ``results.json``.
A failed family is logged and the run goes on; the process then exits 1
naming every failed step. ``--full-analysis`` (the JAX script's figure and
report battery) raises ``NotImplementedError``: it needs
``analysis/figures.py`` and three analysis scripts that draw with
matplotlib, which the port does not have yet (ROADMAP.md Queue 1 item 11).
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
                   help="not ported yet: the analysis battery with figures "
                        "(ROADMAP.md Queue 1 item 11)")
    args = p.parse_args(argv)
    if args.full_analysis:
        raise NotImplementedError(
            "--full-analysis needs analysis/figures.py and the analysis "
            "scripts that draw with matplotlib, which are not ported yet: "
            "ROADMAP.md Queue 1 item 11")

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

    # scripted callers detect a broken phase by the exit code
    if failed:
        print(f"\nrun_all: {len(failed)} step(s) FAILED: {', '.join(failed)}")
        sys.exit(1)
    return failed


if __name__ == "__main__":
    main()
