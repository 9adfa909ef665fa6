"""End-to-end SERVING demo: train -> calibrate -> serve over HTTP -> score a held-out cohort through the live endpoint -> evaluate the served predictions.

    python -m multimodal_survival_prediction_tpu_torch.demo_e2e --synthetic \\
        --data-root /tmp/demo_cohort --models-dir /tmp/demo_models \\
        --out-dir examples/synthetic_demo/results/serving

The port's counterpart of ``scripts/serving/demo_e2e.py``: the same flags,
steps and artifacts, plus ``--device`` (default ``cuda``). A fold-ensemble
``RiskScorer`` behind ``serving.make_server``, with per-fold calibration
from the training cohort, and EVERY prediction in the output CSV travels
through ``POST /score_batch`` over a real socket.

  1. a seed-42 holdout of the labelled patients (``--holdout-frac``, at
     least 4), never seen by CV;
  2. the CV driver on the rest (fold checkpoints under ``--models-dir``,
     reused in any format unless ``--retrain``);
  3. calibration (per-fold mu, sd) on the training cohort;
  4. the server on an OS-assigned port, scoring the holdout in requests of
     ``--serve-batch`` patients;
  5. ``evaluate_predictions`` over the served CSV, and its figures where
     matplotlib imports (one line says they were skipped elsewhere).

Artifacts under --out-dir:
  serving_predictions.csv   held-out patients scored via HTTP
  calibration.json          per-fold (mu, sd) from the TRAINING cohort
  evaluation/               evaluate_model battery over the served CSV
  serving_summary.json      holdout C-index + request accounting

It also prints ``[demo] walls s {...}``: the seconds of training,
calibration, serving (server start to the last reply) and evaluation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from .analysis.evaluate import evaluate_predictions
from .analysis.evaluate_model import draw_evaluation_figures
from .config import ALL_CONFIGS
from .data.matching_table import load_matching_table
from .data.synthetic import SyntheticCohortSpec, generate_synthetic_cohort
from .preprocess.tables import read_table, write_csv
from .serving import RiskScorer, make_server
from .train.cv import run_cross_validation
from .train.predict import fold_checkpoints, predict_risk

PREDICTION_COLUMNS = ("patient_id", "risk_score", "survival_time", "event",
                      "modalities_used")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="partial_modality")
    p.add_argument("--data-root", default="/tmp/serving_demo_cohort")
    p.add_argument("--synthetic", action="store_true",
                   help="generate the synthetic cohort at --data-root if "
                        "its matching table is missing")
    p.add_argument("--synthetic-patients", type=int, default=96)
    p.add_argument("--models-dir", default="/tmp/serving_demo_models")
    p.add_argument("--out-dir",
                   default="examples/synthetic_demo/results/serving")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--n-folds", type=int, default=2)
    p.add_argument("--backbone", default="simple_cnn",
                   choices=["densenet121", "simple_cnn"])
    p.add_argument("--image-shape", default="32,32,32")
    p.add_argument("--serve-batch", type=int, default=8,
                   help="scoring batch (requests micro-batched)")
    p.add_argument("--holdout-frac", type=float, default=0.25,
                   help="labeled patients held OUT of CV training and "
                        "scored only through the HTTP endpoint")
    p.add_argument("--retrain", action="store_true",
                   help="retrain even if fold checkpoints already exist")
    p.add_argument("--device", default="cuda")
    return p


def holdout_split(table: list, frac: float):
    """``(train_table, hold_table)``: ``max(4, round(frac x labelled))``
    labelled patients drawn by ``default_rng(42).permutation`` (JAX's
    draw), each side in table order."""
    labeled = np.asarray([r["patient_id"] for r in table if r["has_survival"]])
    rng = np.random.default_rng(42)
    n_hold = max(4, int(round(len(labeled) * frac)))
    holdout = set(rng.permutation(labeled)[:n_hold].tolist())
    return ([r for r in table if r["patient_id"] not in holdout],
            [r for r in table if r["patient_id"] in holdout])


def _existing_folds(models_dir: Path, name: str) -> list:
    try:
        return fold_checkpoints(models_dir, name)
    except FileNotFoundError:
        return []


def _rna_rows(rnaseq_csv: Path) -> dict:
    """``{patient id: [float, ...]}`` of the RNA matrix, each value as
    ``pd.read_csv(..., index_col=0)`` parses it (the first row of an id)."""
    if not rnaseq_csv.exists():
        return {}
    rna = read_table(rnaseq_csv)
    ids = [str(v) for v in rna.column(rna.columns[0])]
    genes = [rna.column(g) for g in rna.columns[1:]]
    rows: dict = {}
    for i, pid in enumerate(ids):
        rows.setdefault(pid, i)
    return {pid: [float(g[i]) for g in genes] for pid, i in rows.items()}


def request_bodies(hold_table: list, rnaseq_csv: Path):
    """The ``/score_batch`` bodies of the holdout (JAX's): RNA where the
    patient has it, age where finite, the NIfTI path where it exists; a
    patient with none is not sent. Returns ``(bodies, rows)``."""
    rna = _rna_rows(rnaseq_csv)
    bodies, rows = [], []
    for rec in hold_table:
        body = {}
        if rec["has_rnaseq"] and str(rec["patient_id"]) in rna:
            body["rnaseq"] = rna[str(rec["patient_id"])]
        if rec["has_clinical"] and np.isfinite(rec["age"]):
            body["age"] = float(rec["age"])
        if rec["has_imaging"] and rec["nifti_path"]:
            nifti = Path(rec["nifti_path"])
            if not nifti.is_absolute():
                nifti = Path.cwd() / nifti
            if nifti.exists():
                body["nifti_path"] = str(nifti)
        if not body:
            continue
        bodies.append(body)
        rows.append(rec)
    return bodies, rows


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    root = Path(args.data_root)
    table_csv = root / "data" / "processed" / "full_matching_table.csv"
    if not table_csv.exists():
        if not args.synthetic:
            p.error(f"{table_csv} missing (pass --synthetic to generate)")
        generate_synthetic_cohort(
            root, SyntheticCohortSpec(n_patients=args.synthetic_patients,
                                      p_imaging=0.8))
        print(f"[demo] synthetic cohort ({args.synthetic_patients} "
              f"patients) at {root}")

    table = load_matching_table(table_csv)
    rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"

    # -- holdout split: labeled patients only, seeded, never seen by CV -----
    train_table, hold_table = holdout_split(table, args.holdout_frac)
    print(f"[demo] cohort {len(table)} patients: {len(train_table)} to CV "
          f"training, {len(hold_table)} labeled held out for serving")

    cfg = dataclasses.replace(ALL_CONFIGS[args.model],
                              n_folds=args.n_folds, image_shape=image_shape)
    walls = {}

    # -- 1. train (CV driver writes fold_K_best.pt + .meta.json) ------------
    models_dir = Path(args.models_dir)
    have = _existing_folds(models_dir, cfg.name)
    t0 = time.monotonic()
    if args.retrain or len(have) < args.n_folds:
        for old in have:  # the new folds replace them, in .pt
            old.unlink()
            old.with_name(old.name + ".meta.json").unlink(missing_ok=True)
        run_cross_validation(
            cfg, train_table, rnaseq_csv=rnaseq_csv,
            results_dir=str(models_dir / "_results"),
            models_dir=str(models_dir), backbone=args.backbone,
            num_epochs=args.epochs, device=args.device)
        print(f"[demo] trained {cfg.name} ({args.n_folds} folds, "
              f"{args.epochs} epochs) in {time.monotonic() - t0:.0f}s")
    else:
        print(f"[demo] reusing {len(have)} fold checkpoints under "
              f"{models_dir / cfg.name}")
    walls["train"] = time.monotonic() - t0
    ckpts = fold_checkpoints(models_dir, cfg.name)

    # -- 2. calibrate on the TRAINING cohort (never the holdout) ------------
    t0 = time.monotonic()
    _, stats = predict_risk(cfg, ckpts, train_table, rnaseq_csv=rnaseq_csv,
                            return_fold_stats=True, device=args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "calibration.json").write_text(json.dumps({
        "model": cfg.name, "checkpoints": [str(c) for c in ckpts],
        "stats": stats}, indent=2))
    print("[demo] calibration: " + ", ".join(
        f"fold{k} mu={mu:+.3f} sd={sd:.3f}"
        for k, (mu, sd) in enumerate(stats, 1)))
    walls["calibrate"] = time.monotonic() - t0

    # -- 3. serve: fold-ensemble scorer behind a real HTTP socket -----------
    t_serve = time.monotonic()
    scorer = RiskScorer(args.model, ckpts, batch_size=args.serve_batch,
                        fold_calibration=stats, device=args.device)
    server = make_server(scorer, port=0)
    host, port = server.server_address
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{host}:{port}"
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        print(f"[demo] server up at {base}: {r.read().decode()}")

    # -- 4. score the holdout THROUGH the endpoint --------------------------
    patients, meta = request_bodies(hold_table, rnaseq_csv)
    rows, n_requests = [], 0
    t0 = time.monotonic()
    try:
        for start in range(0, len(patients), args.serve_batch):
            chunk = patients[start:start + args.serve_batch]
            req = urllib.request.Request(
                f"{base}/score_batch",
                data=json.dumps({"patients": chunk}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                results = json.loads(r.read())["results"]
            n_requests += 1
            for rec, res in zip(meta[start:start + args.serve_batch],
                                results):
                rows.append({
                    "patient_id": rec["patient_id"],
                    "risk_score": res["risk_score"],
                    "survival_time": float(rec["survival_time"]),
                    "event": int(rec["survival_status"]),
                    "modalities_used": "+".join(
                        k for k, v in res["modalities_used"].items() if v),
                })
        serve_sec = time.monotonic() - t0
    finally:
        server.shutdown()
        server.server_close()
    walls["serve"] = time.monotonic() - t_serve
    pred_csv = out_dir / "serving_predictions.csv"
    write_csv(pred_csv, list(PREDICTION_COLUMNS),
              ([r[c] for c in PREDICTION_COLUMNS] for r in rows))
    print(f"[demo] scored {len(rows)} held-out patients via "
          f"{n_requests} HTTP /score_batch requests in {serve_sec:.1f}s "
          f"-> {pred_csv}")

    # -- 5. evaluate the SERVED predictions (evaluate_model battery) --------
    t0 = time.monotonic()
    pred = {c: np.asarray([r[c] for r in rows]) for c in PREDICTION_COLUMNS}
    ev = out_dir / "evaluation"
    summary = evaluate_predictions(pred, out_dir=ev)
    draw_evaluation_figures(pred, ev,
                            km_title="KM by risk group (served predictions)")
    walls["evaluate"] = time.monotonic() - t0

    out = {
        "model": cfg.name, "n_holdout": len(rows),
        "n_http_requests": n_requests,
        "holdout_c_index": summary["c_index"],
        "logrank_p": summary["logrank"]["p_value"],
        "serve_seconds": round(serve_sec, 1),
        "folds": len(ckpts), "backbone": args.backbone,
    }
    (out_dir / "serving_summary.json").write_text(json.dumps(out, indent=2))
    print(f"[demo] walls s {json.dumps(walls)}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
